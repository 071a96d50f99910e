"""Plane nemesis on the port (jepsen_tpu_torch.checker.chaos and the
dispatch plane's degradation ladder), on the CPU: the single-device
cases of the reference's tests/test_chaos.py.

Every fault class the nemesis injects — transient launch failure, hung
collect, persistent device failure, OOM — leaves the verdicts equal to
a clean run: a retried fault field for field, a fault that spends the
device rungs through the host oracle with the same valid? and
failed_op_index and ``degraded`` on the verdict (on one device there is
no other placement to fall back to; the CPU plane degrades by default,
a plane on the card only with degrade=True, and otherwise fails its
riders with the PlaneFault). The recovery shows in
dispatch_stats()["resilience"].

The differentials run each case on the reference's plane too,
DispatchPlane(interpret=True, mesh=False, race=False) under the same
fault built with jepsen_tpu.checker.chaos's builders, and hold the
verdicts (methods mapped tpu-* -> gpu-*), the degraded block and
RESILIENCE_STATS equal, as classify_fault is held against the
reference's classifier. Where the port departs on purpose the test
names the departure (_DEPARTURES). Tolerance: exact equality. The
seeded soak is also ``slow``, as the reference's is."""

import random
import threading
import time

import pytest
import torch

from jepsen_tpu.checker import chaos as r_chaos
from jepsen_tpu.checker import dispatch as r_dp
from jepsen_tpu.checker import events as r_ev
from jepsen_tpu.checker import linearizable as r_lin
from jepsen_tpu.checker import wgl_bitset as r_bs
from jepsen_tpu.history.history import History as RefHistory
from jepsen_tpu.sim import corrupt_history as r_corrupt
from jepsen_tpu.sim import gen_register_history as r_gen

from jepsen_tpu_torch.checker import _build, chaos
from jepsen_tpu_torch.checker import wgl_bitset as bs
from jepsen_tpu_torch.checker.chaos import (
    DeadlineExceeded,
    InjectedCudaError,
    PlaneFault,
    RetryPolicy,
)
from jepsen_tpu_torch.checker.dispatch import (
    DISPATCH_STATS,
    DispatchPlane,
    dispatch_stats,
    reset_default_plane,
    reset_dispatch_stats,
)
from jepsen_tpu_torch.checker.events import events_to_steps, history_to_events
from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
from jepsen_tpu_torch.checker.models import model as get_model
from jepsen_tpu_torch.convert import from_reference
from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.sim import corrupt_history, gen_register_history

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_nemesis_state():
    """Quarantine and the resilience ledger are process-global: every
    test starts and ends with a clean slate and a fresh default plane."""
    for c in (chaos, r_chaos):
        c.clear_chaos()
        c.reset_resilience()
    reset_dispatch_stats()
    r_dp.reset_dispatch_stats()
    yield
    for c in (chaos, r_chaos):
        c.clear_chaos()
        c.reset_resilience()
    reset_dispatch_stats()
    r_dp.reset_dispatch_stats()
    reset_default_plane()
    r_dp.reset_default_plane()


def _register_streams(n, n_ops=80, corrupt_every=0, seed=7000,
                      p_crash=0.05):
    streams = []
    for i in range(n):
        rng = random.Random(seed + i)
        h = gen_register_history(rng, n_ops=n_ops, n_procs=4,
                                 p_crash=p_crash)
        if corrupt_every and i % corrupt_every == corrupt_every - 1:
            h = corrupt_history(h, rng)
        streams.append(history_to_events(h, model="cas-register"))
    return streams


def _strip(out):
    return {k: v for k, v in out.items() if k not in ("method", "wall_s")}


def _run_plane(streams, **kw):
    with DispatchPlane(device="cpu", **kw) as plane:
        futs = [plane.submit(s) for s in streams]
        plane.flush()
        return [f.result() for f in futs]


def _solo_streams():
    # seed chosen so the corrupted streams really are invalid
    return _register_streams(4, n_ops=40, corrupt_every=2, seed=7120)


# -- primitives (no device) --------------------------------------------------


def test_classify_fault_classes():
    assert chaos.classify_fault(
        chaos.transient_fault().build()) == "transient"
    assert chaos.classify_fault(chaos.oom_fault().build()) == "oom"
    assert chaos.classify_fault(
        chaos.persistent_device_fault("cuda:0").build()) == "fatal"
    assert chaos.classify_fault(DeadlineExceeded("blew budget")) == "deadline"
    assert chaos.classify_fault(ValueError("boom")) == "error"
    assert chaos.classify_fault(_build.BuildError("nvcc failed")) == "error"
    assert chaos.classify_fault(RuntimeError(
        "CUDA error: an illegal memory access was encountered")) == "fatal"
    assert chaos.classify_fault(
        torch.cuda.OutOfMemoryError("CUDA out of memory")) == "oom"
    assert chaos.classify_fault(
        RuntimeError("CUDA error: out of memory")) == "oom"


@pytest.mark.parametrize("code,kind", (
    (2, "oom"), (700, "fatal"), (719, "fatal"), (1, "fatal"),
))
def test_launcher_cuda_errors_classify(code, kind):
    """The port's ctypes launchers raise _build.CudaError with the
    cudaError_t: 2 (cudaErrorMemoryAllocation) is oom; the sticky 700
    and 719 poison the context and are fatal, as is any other code."""
    with pytest.raises(_build.CudaError) as ei:
        _build.check(code, "bitset_scan")
    assert ei.value.cuda_error == code
    assert chaos.classify_fault(ei.value) == kind


def test_attribute_device_needs_evidence():
    devs = ["cuda:0", "cuda:1"]
    tagged = InjectedCudaError("boom", 719, device="cuda:1")
    assert chaos.attribute_device(tagged, devs) == "cuda:1"
    named = RuntimeError("launch failed on cuda:0: bad")
    assert chaos.attribute_device(named, devs) == "cuda:0"
    assert chaos.attribute_device(RuntimeError("anon"), devs) is None


def test_retry_policy_backoff_is_bounded():
    p = RetryPolicy(max_retries=5, base_delay_s=0.01, multiplier=2.0,
                    max_delay_s=0.05)
    delays = [p.delay(a) for a in range(6)]
    assert delays[0] == 0.01 and delays[1] == 0.02
    assert all(d <= 0.05 for d in delays)
    assert delays == sorted(delays)


def test_note_device_failure_quarantines_exactly_once():
    assert chaos.note_device_failure("d0", quarantine_after=3) is False
    assert chaos.note_device_failure("d0", quarantine_after=3) is False
    assert chaos.note_device_failure("d0", quarantine_after=3) is True
    assert chaos.note_device_failure("d0", quarantine_after=3) is False
    assert chaos.is_quarantined("d0")
    assert chaos.quarantined_devices() == ("d0",)
    assert chaos.device_failures()["d0"] == 4


def test_run_with_deadline():
    assert chaos.run_with_deadline(lambda: 7, 5.0) == 7
    with pytest.raises(DeadlineExceeded):
        chaos.run_with_deadline(lambda: time.sleep(5), 0.05)
    with pytest.raises(KeyError):
        chaos.run_with_deadline(lambda: {}["missing"], 5.0)


def test_resilient_call_retries_transient_then_succeeds():
    calls = {"n": 0}

    def thunk():
        calls["n"] += 1
        if calls["n"] < 3:
            raise chaos.transient_fault().build()
        return "ok"

    out = chaos.resilient_call(
        thunk, site="launch",
        policy=RetryPolicy(max_retries=3, base_delay_s=0.0),
    )
    assert out == "ok" and calls["n"] == 3
    assert chaos.RESILIENCE_STATS["retries"] == 2


def test_resilient_call_wraps_exhaustion_in_plane_fault():
    def thunk():
        _build.check(719, "bitset_scan")  # a sticky launch failure

    with pytest.raises(PlaneFault) as ei:
        chaos.resilient_call(thunk, site="launch")
    pf = ei.value
    assert pf.kind == "fatal" and pf.attempts == 1
    assert isinstance(pf.cause, _build.CudaError)
    assert pf.describe()["site"] == "launch"


@pytest.mark.parametrize("err", (
    ValueError("not a device error"),
    _build.BuildError("nvcc failed for bitset_scan.cu"),
))
def test_resilient_call_reraises_program_errors(err):
    """An error that names no device (a bug in a wrapper, a kernel that
    did not build) is the program's: re-raised as it is, at once, with
    no retry and nothing counted."""
    calls = {"n": 0}

    def thunk():
        calls["n"] += 1
        raise err

    with pytest.raises(type(err)) as ei:
        chaos.resilient_call(thunk, site="launch",
                             policy=RetryPolicy(base_delay_s=0.0))
    assert ei.value is err and calls["n"] == 1
    assert chaos.RESILIENCE_STATS["retries"] == 0


def test_chaos_fault_schedule_and_site_matching():
    with chaos.chaos_plan(chaos.transient_fault(site="launch", times=2)):
        for _ in range(2):
            with pytest.raises(InjectedCudaError):
                chaos.inject("launch", ["cuda:0"])
        chaos.inject("launch", ["cuda:0"])  # budget spent
        chaos.inject("collect", [])  # site mismatch never fires
    chaos.inject("launch", [])  # no plan installed: a no-op
    assert chaos.RESILIENCE_STATS["faults_injected"] == 2


def test_device_scoped_fault_only_matches_its_device():
    with chaos.chaos_plan(chaos.persistent_device_fault("cuda:3")):
        chaos.inject("launch", ["cuda:0", "cuda:1"])
        with pytest.raises(InjectedCudaError) as ei:
            chaos.inject("launch", ["cuda:2", "cuda:3"])
        assert ei.value.chaos_device == "cuda:3"
        with pytest.raises(InjectedCudaError):
            chaos.inject("collect", ["cuda:3"])  # any site, forever


def test_seeded_probabilistic_plan_is_replayable():
    def fire_count():
        n = 0
        with chaos.chaos_plan(seed=99, p_transient=0.5):
            for _ in range(64):
                try:
                    chaos.inject("launch", [])
                except InjectedCudaError:
                    n += 1
        return n

    a = fire_count()
    chaos.reset_resilience()
    b = fire_count()
    assert a == b and 0 < a < 64


# -- differential: fault class vs clean verdicts -----------------------------


def test_transient_launch_fault_retries_to_parity():
    streams = _solo_streams()
    clean = _run_plane(streams)
    assert not all(o["valid?"] for o in clean)  # really differential
    chaos.reset_resilience()
    with chaos.chaos_plan(chaos.transient_fault(site="launch", times=1)):
        faulted = _run_plane(streams)
    for c, f in zip(clean, faulted):
        assert _strip(c) == _strip(f), (c, f)
    res = dispatch_stats()["resilience"]
    assert res["faults_injected"] == 1
    assert res["retries"] >= 1
    assert res["quarantined_devices"] == []
    assert res["oracle_fallbacks"] == 0


@pytest.mark.parametrize("fault", ("oom", "persistent"))
def test_unretryable_fault_degrades_to_host_oracle(fault):
    """An OOM (the same shape re-OOMs) or a sticky device fault is never
    retried; on one device the ladder has no other placement, so every
    rider resolves from the host oracle: the same valid? and
    failed_op_index, ``degraded`` on the verdict, counted."""
    streams = _solo_streams()
    clean = _run_plane(streams)
    chaos.reset_resilience()
    spec = (chaos.oom_fault(site="launch", times=1) if fault == "oom"
            else chaos.persistent_device_fault("cpu"))
    with chaos.chaos_plan(spec):
        faulted = _run_plane(streams)
    kind = "oom" if fault == "oom" else "fatal"
    for c, f in zip(clean, faulted):
        assert f["valid?"] == c["valid?"], (c, f)
        assert f.get("failed_op_index") == c.get("failed_op_index")
        assert f["method"].startswith("cpu-oracle"), f
        assert f["degraded"]["kind"] == kind
    res = dispatch_stats()["resilience"]
    assert res["retries"] == 0
    assert res["degradations"] >= 1
    assert res["oracle_fallbacks"] == len(streams)


def test_hang_once_at_collect_deadline_cuts_and_retries():
    streams = _solo_streams()
    clean = _run_plane(streams)
    chaos.reset_resilience()
    with chaos.chaos_plan(
        chaos.hang_fault(site="collect", times=1, delay_s=30.0)
    ):
        faulted = _run_plane(
            streams, launch_deadline_s=0.5,
            retry=RetryPolicy(max_retries=3, base_delay_s=0.001),
        )
    for c, f in zip(clean, faulted):
        assert _strip(c) == _strip(f), (c, f)
    res = dispatch_stats()["resilience"]
    assert res["deadline_hits"] >= 1
    assert res["retries"] >= 1
    assert res["oracle_fallbacks"] == 0


def test_persistent_hang_degrades_to_host_oracle():
    streams = _solo_streams()
    clean = _run_plane(streams)
    chaos.reset_resilience()
    with chaos.chaos_plan(
        chaos.hang_fault(site="collect", times=None, delay_s=30.0)
    ):
        faulted = _run_plane(
            streams, launch_deadline_s=0.3,
            retry=RetryPolicy(max_retries=1, base_delay_s=0.001),
        )
    for c, f in zip(clean, faulted):
        assert f["valid?"] == c["valid?"], (c, f)
        assert f.get("failed_op_index") == c.get("failed_op_index"), (c, f)
        assert f["method"].startswith("cpu-oracle"), f
        assert f["degraded"]["kind"] == "deadline"
    res = dispatch_stats()["resilience"]
    assert res["deadline_hits"] >= 1
    assert res["oracle_fallbacks"] == len(streams)


def test_checker_check_and_check_async_survive_faults():
    """LinearizableChecker.check/check_async through a faulted plane
    return the plane-less checker's verdicts — no raw exception crosses
    the resolver, even when every device rung is dead, and the
    fallback is disclosed."""
    rng = random.Random(46)
    hs = []
    for i in range(3):
        h = gen_register_history(rng, n_ops=60, n_procs=3)
        if i == 1:
            h = corrupt_history(h, rng)
        hs.append(History(h.ops))
    base = LinearizableChecker(device="cpu")
    seq = [base.check(None, h) for h in hs]
    with chaos.chaos_plan(
        chaos.hang_fault(site="collect", times=None, delay_s=30.0)
    ):
        with DispatchPlane(
            device="cpu", launch_deadline_s=0.3,
            retry=RetryPolicy(max_retries=1, base_delay_s=0.001),
        ) as plane:
            c = LinearizableChecker(plane=plane)
            direct = c.check(None, hs[0])
            resolvers = [c.check_async(None, h) for h in hs]
            plane.flush()
            outs = [r() for r in resolvers]
    for s, p in zip([seq[0]] + seq, [direct] + outs):
        assert p["valid?"] == s["valid?"], (s, p)
        assert p.get("failed_op_index") == s.get("failed_op_index")
        assert "degraded" in p


def _bitset_batch(streams=None):
    streams = _solo_streams() if streams is None else streams
    W = max(bs.w_bucket(max(s.window, 1)) for s in streams)
    m = get_model("cas-register")
    S = bs._rows_bucket(
        max(m.bitset_rows(len(s.value_codes)) for s in streams)
    )
    return [events_to_steps(s, W=W) for s in streams], S


def test_check_keys_bitset_transient_parity():
    """The steps-level entry (run_keys on the default plane): a
    transient launch fault retries to identical raw verdicts."""
    steps, S = _bitset_batch()
    clean = bs.check_keys_bitset(steps, S=S, device="cpu")
    chaos.reset_resilience()
    with chaos.chaos_plan(chaos.transient_fault(site="launch", times=1)):
        faulted = bs.check_keys_bitset(steps, S=S, device="cpu")
    assert list(clean) == list(faulted)
    res = chaos.resilience_snapshot()
    assert res["retries"] >= 1 and res["faults_injected"] == 1


def test_collect_time_exact_rerun_runs_guarded():
    """A fast-tier death's exact re-run happens at collect, outside the
    plane's launch guard: it runs through its own chaos seam, so a
    transient fault there retries to the same verdicts."""
    steps, S = _bitset_batch()
    clean = bs.collect_keys_bitset(
        bs.launch_keys_bitset(steps, S=S, device="cpu"))
    assert not all(v[0] for v in clean)  # the re-run really happens
    handle = bs.launch_keys_bitset(steps, S=S, device="cpu")
    with chaos.chaos_plan(chaos.transient_fault(site="launch", times=1)):
        got = bs.collect_keys_bitset(handle)
    assert got == clean
    assert chaos.RESILIENCE_STATS["retries"] == 1


def test_run_keys_unrecoverable_fault_is_structured():
    """Raw steps carry no events to re-decide on the host: a dead
    device rung surfaces as a structured PlaneFault, never the raw
    device exception."""
    steps, S = _bitset_batch()
    with chaos.chaos_plan(chaos.persistent_device_fault("cpu")):
        with pytest.raises(PlaneFault) as ei:
            bs.check_keys_bitset(steps, S=S, device="cpu")
    assert ei.value.kind == "fatal"
    assert chaos.RESILIENCE_STATS["plane_faults"] == len(steps)


# -- against the reference's chaos module and plane -------------------------

#: (error message, the port's kind, the reference's kind) on the same
#: RuntimeError; rows where the kinds differ are the port's departures:
#: an error naming no device is the program's ("error", re-raised), and
#: a CUDA error with no other mark is a sticky device error (fatal)
_CLASSIFY = (
    ("CUDA error: out of memory", "oom", "oom"),
    ("RESOURCE_EXHAUSTED: Out of memory while trying to allocate", "oom",
     "oom"),
    ("oom in the allocator", "oom", "oom"),
    ("transient failure, try again", "transient", "transient"),
    ("connection reset by peer", "transient", "transient"),
    ("CUDA error: an illegal memory access was encountered", "fatal",
     "fatal"),
    ("CUDA error: device busy", "transient", "fatal"),
    ("boom", "error", "fatal"),
)


@pytest.mark.parametrize("msg,port_kind,ref_kind", _CLASSIFY)
def test_classify_fault_against_reference(msg, port_kind, ref_kind):
    assert r_chaos.classify_fault(RuntimeError(msg)) == ref_kind
    assert chaos.classify_fault(RuntimeError(msg)) == port_kind


@pytest.mark.parametrize("builder", ("transient_fault", "oom_fault",
                                     "persistent_device_fault"))
def test_injected_faults_classify_as_the_reference_s(builder):
    """Each builder's injected error classifies as the reference's own
    does, except the persistent fault (_DEPARTURES)."""
    args = ("dev0",) if builder == "persistent_device_fault" else ()
    want = r_chaos.classify_fault(getattr(r_chaos, builder)(*args).build())
    got = chaos.classify_fault(getattr(chaos, builder)(*args).build())
    assert got == _DEPARTURES.get(builder, {}).get("kind", want)
    assert want == _DEPARTURES.get(builder, {}).get("ref_kind", want)


#: the port's departures from the reference on the same fault: the
#: reference's injected persistent fault is XlaRuntimeError-shaped,
#: which its classifier reads as transient, so it retries max_retries
#: times before it degrades; the port's is a sticky CUDA error
#: (cudaErrorLaunchFailure), fatal at the first attempt
_DEPARTURES = {
    "persistent_device_fault": {"kind": "fatal", "ref_kind": "transient"},
}


def _ref_pair():
    """The solo family as (reference streams, port streams), the port's
    carried across with convert.from_reference."""
    ref = []
    for i in range(4):
        rng = random.Random(7120 + i)
        h = r_gen(rng, n_ops=40, n_procs=4, p_crash=0.05)
        if i % 2 == 1:
            h = r_corrupt(h, rng)
        ref.append(r_ev.history_to_events(h, model="cas-register"))
    return ref, [from_reference(s) for s in ref]


def _map_method(m: str) -> str:
    return "gpu-" + m[4:] if m.startswith("tpu-") else m


def _ref_plane(streams, **kw):
    with r_dp.DispatchPlane(interpret=True, mesh=False, race=False,
                            **kw) as plane:
        futs = [plane.submit(s) for s in streams]
        plane.flush()
        return [f.result() for f in futs]


def _res_stats(c):
    return {k: c.RESILIENCE_STATS[k] for k in chaos.RESILIENCE_STATS}


#: case -> (the faults, built from either chaos module; the plane's
#: keyword arguments, from either module)
_PLANE_CASES = {
    "transient": (
        lambda c: [c.transient_fault(site="launch", times=1)],
        lambda c: {},
    ),
    "oom": (
        lambda c: [c.oom_fault(site="launch", times=1)],
        lambda c: {},
    ),
    "persistent": (
        lambda c: [c.ChaosFault("persistent", times=None)],
        lambda c: {"retry": c.RetryPolicy(max_retries=3,
                                          base_delay_s=0.001)},
    ),
    "hang_once": (
        lambda c: [c.hang_fault(site="collect", times=1, delay_s=30.0)],
        lambda c: {"launch_deadline_s": 2.0,
                   "retry": c.RetryPolicy(max_retries=3,
                                          base_delay_s=0.001)},
    ),
    "hang_forever": (
        lambda c: [c.hang_fault(site="collect", times=None, delay_s=30.0)],
        lambda c: {"launch_deadline_s": 1.0,
                   "retry": c.RetryPolicy(max_retries=1,
                                          base_delay_s=0.001)},
    ),
}


@pytest.mark.parametrize("case", tuple(_PLANE_CASES))
def test_fault_ladder_matches_reference_plane(case):
    """The same streams under the same fault on both planes: every
    verdict field equal (method mapped), the same degraded site, kind
    and attempts, and the same RESILIENCE_STATS; the persistent fault
    differs only as _DEPARTURES says."""
    faults, kw = _PLANE_CASES[case]
    ref_streams, streams = _ref_pair()
    _ref_plane(ref_streams)  # compiles the reference's shapes first
    r_chaos.reset_resilience()
    with r_chaos.chaos_plan(*faults(r_chaos)):
        want = _ref_plane(ref_streams, **kw(r_chaos))
    want_res = _res_stats(r_chaos)
    with chaos.chaos_plan(*faults(chaos)):
        got = _run_plane(streams, **kw(chaos))
    got_res = _res_stats(chaos)
    if case == "persistent":
        retries = want_res["retries"]
        assert retries == 3
        for w in want:
            assert w["degraded"]["kind"] == "transient"
            assert w["degraded"]["attempts"] == retries + 1
            w["degraded"].update(kind="fatal", attempts=1)
        want_res.update(retries=0,
                        faults_injected=want_res["faults_injected"]
                        - retries)
    for g, w in zip(got, want):
        gd, wd = g.pop("degraded", None), w.pop("degraded", None)
        assert _strip(g) == _strip(w), (case, g, w)
        assert g["method"] == _map_method(w["method"]), (case, g, w)
        assert (gd is None) == (wd is None), (case, gd, wd)
        if gd is not None:
            for k in ("site", "kind", "attempts"):
                assert gd[k] == wd[k], (case, k, gd, wd)
    assert got_res == want_res, (case, got_res, want_res)
    if case in ("oom", "persistent", "hang_forever"):
        assert got_res["oracle_fallbacks"] == len(streams)
    else:
        assert got_res["oracle_fallbacks"] == 0


def test_checker_survives_faults_as_reference_checker():
    """LinearizableChecker.check and check_async through a plane whose
    every collect hangs: the port's verdicts equal the reference
    checker's on its plane, degraded the same way."""
    rng = random.Random(46)
    ref_hs, hs = [], []
    for i in range(3):
        h = r_gen(rng, n_ops=60, n_procs=3)
        if i == 1:
            h = r_corrupt(h, rng)
        ref_hs.append(RefHistory(h.ops))
        hs.append(History([o.to_dict() for o in h.ops]))

    def drive(c, plane, checker, histories):
        direct = checker.check({}, histories[0])
        resolvers = [checker.check_async({}, h) for h in histories]
        plane.flush()
        return [direct] + [r() for r in resolvers]

    hang = dict(site="collect", times=None, delay_s=30.0)
    with r_chaos.chaos_plan(r_chaos.hang_fault(**hang)):
        with r_dp.DispatchPlane(
            interpret=True, mesh=False, race=False, launch_deadline_s=1.0,
            retry=r_chaos.RetryPolicy(max_retries=1, base_delay_s=0.001),
        ) as plane:
            want = drive(r_chaos, plane, r_lin.LinearizableChecker(
                model="cas-register", plane=plane), ref_hs)
    with chaos.chaos_plan(chaos.hang_fault(**hang)):
        with DispatchPlane(
            device="cpu", launch_deadline_s=1.0,
            retry=RetryPolicy(max_retries=1, base_delay_s=0.001),
        ) as plane:
            got = drive(chaos, plane, LinearizableChecker(plane=plane), hs)
    assert not all(w["valid?"] for w in want)
    for g, w in zip(got, want):
        for k in ("valid?", "failed_op_index", "n_ops", "window"):
            assert g.get(k) == w.get(k), (k, g, w)
        assert g["degraded"]["kind"] == w["degraded"]["kind"] == "deadline"


def test_check_keys_bitset_transient_parity_with_reference():
    """check_keys_bitset (run_keys on the default plane) under one
    transient launch fault: the reference's raw verdicts and counts."""
    ref_streams, streams = _ref_pair()
    steps, S = _bitset_batch(streams)
    ref_steps = [r_ev.events_to_steps(s, W=steps[0].W)
                 for s in ref_streams]
    r_bs.check_keys_bitset(ref_steps, S=S, interpret=True, mesh=False)
    r_chaos.reset_resilience()
    with r_chaos.chaos_plan(r_chaos.transient_fault(site="launch", times=1)):
        want = r_bs.check_keys_bitset(ref_steps, S=S, interpret=True,
                                      mesh=False)
    with chaos.chaos_plan(chaos.transient_fault(site="launch", times=1)):
        got = bs.check_keys_bitset(steps, S=S, device="cpu")
    assert [tuple(map(int, v)) for v in got] == [
        tuple(map(int, v)) for v in want]
    assert _res_stats(chaos) == _res_stats(r_chaos)


def test_run_keys_fault_is_structured_as_reference():
    """Raw steps under a persistent fault: both planes fail every rider
    with a structured PlaneFault, counted alike (the kind and attempts
    as _DEPARTURES says)."""
    ref_streams, streams = _ref_pair()
    steps, S = _bitset_batch(streams)
    ref_steps = [r_ev.events_to_steps(s, W=steps[0].W)
                 for s in ref_streams]
    with r_chaos.chaos_plan(r_chaos.ChaosFault("persistent", times=None)):
        with pytest.raises(r_chaos.PlaneFault) as want:
            r_bs.check_keys_bitset(ref_steps, S=S, interpret=True,
                                   mesh=False)
    with chaos.chaos_plan(chaos.ChaosFault("persistent", times=None)):
        with pytest.raises(PlaneFault) as got:
            bs.check_keys_bitset(steps, S=S, device="cpu")
    assert want.value.kind == "transient" and got.value.kind == "fatal"
    assert (r_chaos.RESILIENCE_STATS["plane_faults"]
            == chaos.RESILIENCE_STATS["plane_faults"] == len(steps))


def test_worker_leak_matches_reference():
    """A wedged prep worker: both planes' close() return within budget
    and fail every pending future with a worker-leak PlaneFault."""
    ref_streams, streams = _ref_pair()
    outs = []
    for plane, subs in (
        (r_dp.DispatchPlane(interpret=True, mesh=False, race=False,
                            async_prep=True, worker_join_s=0.3),
         ref_streams[:2]),
        (DispatchPlane(device="cpu", async_prep=True, worker_join_s=0.3),
         streams[:2]),
    ):
        release = threading.Event()
        plane._pump = lambda *a, **k: release.wait()
        try:
            futs = [plane.submit(s) for s in subs]
            plane.close()
            kinds = []
            for f in futs:
                try:
                    f.result()
                except RuntimeError as e:
                    kinds.append(getattr(e, "kind", None))
            outs.append(kinds)
        finally:
            release.set()
    assert outs[0] == outs[1] == ["worker-leak"] * 2
    assert r_dp.DISPATCH_STATS["pending_at_close"] == DISPATCH_STATS[
        "pending_at_close"] == 2


# -- a plane that does not degrade (the card's default) ----------------------


def test_non_degrading_plane_fails_riders_with_the_fault():
    """degrade=False (the card's default; on the CPU only when asked): a
    spent budget fails every rider with the structured PlaneFault, and
    the checker raises it — the host oracle never stands in."""
    assert DispatchPlane(device="cpu").degrade is True
    streams = _solo_streams()
    with chaos.chaos_plan(chaos.persistent_device_fault("cpu")):
        with DispatchPlane(device="cpu", degrade=False) as plane:
            futs = [plane.submit(s) for s in streams]
            plane.flush()
            for f in futs:
                with pytest.raises(PlaneFault) as ei:
                    f.result()
                assert ei.value.kind == "fatal"
            checker = LinearizableChecker(plane=plane)
            h = gen_register_history(random.Random(3), n_ops=40, n_procs=3)
            with pytest.raises(PlaneFault):
                checker.check(None, History(h.ops))
    res = chaos.resilience_snapshot()
    assert res["oracle_fallbacks"] == 0 and res["degradations"] == 0
    assert res["plane_faults"] == len(streams) + 1


@pytest.mark.parametrize("site", ("launch", "collect"))
def test_program_errors_reach_the_caller(monkeypatch, site):
    """A Python error in a launch or at collect (here: a wrapper that
    raises) fails the riders with that error, on a degrading plane too:
    no retry, no oracle verdict."""
    streams = _solo_streams()
    if site == "launch":
        def broken(*a, **k):
            raise ValueError("a bug in the launch wrapper")

        monkeypatch.setattr(bs, "launch_keys_bitset", broken)
    else:
        def broken(self, hosts):
            raise ValueError("a bug in the collect")

        monkeypatch.setattr(DispatchPlane, "_train_get", broken)
    with DispatchPlane(device="cpu", degrade=True) as plane:
        futs = [plane.submit(s) for s in streams]
        plane.flush()
        for f in futs:
            with pytest.raises(ValueError, match="a bug"):
                f.result()
    res = chaos.resilience_snapshot()
    assert res["retries"] == 0 and res["oracle_fallbacks"] == 0


# -- lifecycle: leaks never drop riders --------------------------------------


def test_close_detects_worker_leak_and_resolves_pending():
    streams = _register_streams(2, n_ops=30, seed=7800, p_crash=0.0)
    release = threading.Event()
    plane = DispatchPlane(device="cpu", async_prep=True, worker_join_s=0.3)
    plane._pump = lambda *a, **k: release.wait()  # the wedge stand-in
    try:
        futs = [plane.submit(s) for s in streams]
        t0 = time.perf_counter()
        plane.close()
        assert time.perf_counter() - t0 < 5.0
        for f in futs:
            with pytest.raises(PlaneFault) as ei:
                f.result()
            assert ei.value.kind == "worker-leak"
        assert DISPATCH_STATS["pending_at_close"] == len(futs)
    finally:
        release.set()


# -- seeded soak -------------------------------------------------------------


@pytest.mark.slow
def test_seeded_chaos_soak_parity():
    """A seeded probabilistic transient plan plus scheduled faults over
    24 mixed streams through the async-prep plane: verdicts match the
    clean run on every stream, and the prep worker swallowed nothing."""
    streams = []
    for i in range(24):
        rng = random.Random(9900 + i)
        h = gen_register_history(
            rng, n_ops=60 + (i % 4) * 30, n_procs=4,
            p_crash=0.25 if i % 6 == 0 else 0.02,
        )
        if i % 4 == 1:
            h = corrupt_history(h, rng)
        streams.append(history_to_events(h, model="cas-register"))
    clean = _run_plane(streams)
    chaos.reset_resilience()
    reset_dispatch_stats()
    with chaos.chaos_plan(
        chaos.transient_fault(site="launch", times=2),
        chaos.oom_fault(site="launch", times=1),
        seed=1234, p_transient=0.15,
    ):
        faulted = _run_plane(
            streams, async_prep=True,
            retry=RetryPolicy(max_retries=4, base_delay_s=0.001),
        )
    for i, (c, f) in enumerate(zip(clean, faulted)):
        assert f["valid?"] == c["valid?"], (i, c, f)
        assert f.get("failed_op_index") == c.get("failed_op_index"), (
            i, c, f,
        )
    res = dispatch_stats()["resilience"]
    assert res["faults_injected"] >= 3
    assert res["retries"] >= 1
    assert DISPATCH_STATS["worker_errors"] == 0
