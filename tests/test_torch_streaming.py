"""The port's streaming checker (jepsen_tpu_torch.checker.streaming, the
plane's stream bucket, launch_tails_bitset) against the JAX package's,
on the CPU.

Every case of tests/test_streaming.py but the service, mesh, CLI and
donation ones runs on both packages: the reference with interpret=True
(its plane DispatchPlane(interpret=True, mesh=False, race=False)), the
port with device="cpu", each appending the same recipe's ops built in
its own package. Compared after every append: status() ("valid?",
"checked_steps", "exact", "deferred"); at the end: result() ("valid?",
"failed_op_index", "failure", "escalations", the method mapped tpu-* ->
gpu-*) and the deltas of STREAM_STATS, LAUNCH_STATS and DISPATCH_STATS
(the keys both have). Where streams coalesce on threads, how the
arrivals split into stacked launches is a matter of timing: those cases
compare every count but the batch formation, and hold both packages to
the reference test's bound. _prefix_sha is pinned equal to the
reference's on steps carried across by convert.from_reference, and a
stream file written by either package resumes in the other.

Both packages run with the small_w seam (W buckets 4 and 5 prepended),
as the reference's own tests do. Tolerance: exact equality."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_tpu.checker import dispatch as r_dp
from jepsen_tpu.checker import events as r_ev
from jepsen_tpu.checker import linearizable as r_lin
from jepsen_tpu.checker import streaming as r_sm
from jepsen_tpu.checker import wgl_bitset as r_bs
from jepsen_tpu.history import ops as r_ops
from jepsen_tpu.history.history import History as RHistory

from jepsen_tpu_torch import device as t_dev
from jepsen_tpu_torch.checker import chaos as t_chaos
from jepsen_tpu_torch.checker import dispatch as t_dp
from jepsen_tpu_torch.checker import events as t_ev
from jepsen_tpu_torch.checker import linearizable as t_lin
from jepsen_tpu_torch.checker import streaming as t_sm
from jepsen_tpu_torch.checker import wgl_bitset as t_bs
from jepsen_tpu_torch.convert import from_reference
from jepsen_tpu_torch.history import ops as t_ops
from jepsen_tpu_torch.history.history import History as THistory

REPO = Path(__file__).resolve().parents[1]

OPS = {"ref": r_ops, "port": t_ops}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_w(monkeypatch):
    monkeypatch.setattr(r_bs, "W_BUCKETS", (4, 5) + r_bs.W_BUCKETS)
    monkeypatch.setattr(t_bs, "W_BUCKETS", (4, 5) + t_bs.W_BUCKETS)


def burst(pkg, rounds=1, pairs=30, bad_tail=False, nburst=5):
    """tests/test_streaming.py's burst_history, as a package's ops."""
    ops = OPS[pkg]
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


def bad_read_tail(pkg):
    """Two sequential reads observing different values with no write in
    between: invalid, and no new value code or window growth."""
    ops = OPS[pkg]
    return [ops.invoke_op(0, "read"), ops.ok_op(0, "read", 0),
            ops.invoke_op(0, "read"), ops.ok_op(0, "read", 1)]


def seq_chunk(pkg, r, pairs=8):
    ops = OPS[pkg]
    out = []
    for i in range(pairs):
        out.append(ops.invoke_op(0, "write", (r + i) % 3))
        out.append(ops.ok_op(0, "write", (r + i) % 3))
    return out


def stream(pkg, **kw):
    if pkg == "ref":
        return r_sm.StreamingCheck(interpret=True, **kw)
    return t_sm.StreamingCheck(device="cpu", **kw)


def reset_all():
    r_sm.reset_stream_stats()
    t_sm.reset_stream_stats()
    r_bs.reset_launch_stats()
    t_dev.reset_launch_stats()
    r_dp.reset_dispatch_stats()
    t_dp.reset_dispatch_stats()


#: DISPATCH_STATS keys that depend on how threaded arrivals split into
#: stacked launches
BATCHING = {"batches", "batched_requests", "max_batch", "stream_batches",
            "train_registers", "train_inflight_accum",
            "backpressure_collects", "coalesce_wait_us"}


def stats(pkg, batching=True):
    if pkg == "ref":
        s, l, d = (r_sm.stream_stats(), r_bs.launch_stats_snapshot(),
                   dict(r_dp.DISPATCH_STATS))
    else:
        s, l, d = (t_sm.stream_stats(), t_dev.launch_stats_snapshot(),
                   dict(t_dp.DISPATCH_STATS))
    keys = set(t_dp.DISPATCH_STATS) & set(r_dp.DISPATCH_STATS)
    keys -= {"coalesce_wait_us"} if batching else BATCHING
    return (s, {k: l[k] for k in ("launches", "escalations", "host_syncs")},
            {k: d[k] for k in sorted(keys)})


def same_stats(batching=True):
    r, t = stats("ref", batching), stats("port", batching)
    assert r == t, (r, t)
    return t


STATUS = ("valid?", "checked_steps", "exact", "deferred", "n_ops")


def status(st):
    return {k: st.get(k) for k in STATUS}


def verdict(out):
    got = {k: out.get(k) for k in ("valid?", "failed_op_index", "failure",
                                   "escalations")}
    got["method"] = out["method"].replace("tpu-", "gpu-")
    return got


def drive(pkg, chunks, **kw):
    """One stream of `pkg` over the chunks: (statuses, result, handle)."""
    sc = stream(pkg, **kw)
    seen = [status(sc.append(c)) for c in chunks]
    return seen, sc.result(), sc


def both(chunks_of, **kw):
    """The same appends on both packages: the statuses after each
    append and the result are equal; returns the port's."""
    reset_all()
    r = drive("ref", chunks_of("ref"), **kw)
    t = drive("port", chunks_of("port"), **kw)
    assert t[0] == r[0]
    assert verdict(t[1]) == verdict(r[1])
    return r, t


def oneshot(pkg, ops):
    if pkg == "ref":
        ev = r_ev.history_to_events(RHistory(ops), model="cas-register")
        return r_lin.check_events_bucketed(
            ev, model="cas-register", interpret=True, race=False)
    ev = t_ev.history_to_events(THistory(ops), model="cas-register")
    return t_lin.check_events_bucketed(ev, model="cas-register",
                                       device="cpu")


def chunked(ops, n):
    return [ops[i:i + n] for i in range(0, len(ops), n)]


# -- the hashes ---------------------------------------------------------------


def test_prefix_sha_and_rows_equal_the_reference(small_w):
    evr = r_ev.history_to_events(RHistory(burst("ref", rounds=2)))
    sr = r_ev.events_to_steps(evr, W=evr.window)
    carried = from_reference(sr)
    evt = t_ev.history_to_events(THistory(burst("port", rounds=2)))
    st = t_ev.events_to_steps(evt, W=evt.window)
    for steps in (carried, st):
        assert t_sm._rows_bytes(steps, 3, 40, 7) == r_sm._rows_bytes(
            sr, 3, 40, 7)
        for kw in ({}, {"start": 5, "idx_off": 9},
                   {"base_steps": 12, "base_sha": "ab"}):
            assert t_sm._prefix_sha(steps, 30, "cas-register", 8, **kw) \
                == r_sm._prefix_sha(sr, 30, "cas-register", 8, **kw)
    assert t_sm.VERSION == r_sm.VERSION == 2


# -- incremental == one-shot ---------------------------------------------------


@pytest.mark.parametrize("bad", [False, True])
def test_append_incremental_matches_oneshot(small_w, bad):
    r, t = both(lambda p: chunked(burst(p, rounds=2, bad_tail=bad), 24))
    st = same_stats()
    want = oneshot("port", burst("port", rounds=2, bad_tail=bad))
    assert t[1]["valid?"] is want["valid?"] is (not bad)
    assert t[1].get("failed_op_index") == want.get("failed_op_index")
    assert t[1]["method"] == "gpu-wgl-bitset-streaming"
    if bad:
        assert t[1]["failure"]["failed_op"] == want["failure"]["failed_op"]
        # invalid is terminal
        for pkg, (_, _, sc) in (("ref", r), ("port", t)):
            again = sc.append(burst(pkg, pairs=2, nburst=2))
            assert again["valid?"] is False
        assert t[2].result()["failed_op_index"] == want["failed_op_index"]
    else:
        assert st[0]["deferred"] == st[0]["escalations"] == 0
        assert st[1]["host_syncs"] == st[0]["tail_launches"]


def test_checker_check_streaming_handle(small_w):
    """check_streaming binds the checker's config: one append and the
    result equal the checker's own one-shot check."""
    reset_all()
    rc = r_lin.LinearizableChecker(interpret=True)
    tc = t_lin.LinearizableChecker(device="cpu")
    rs, ts = rc.check_streaming(), tc.check_streaming()
    assert ts.device == torch.device("cpu") and ts.plane is None
    rs.append(burst("ref"))
    ts.append(burst("port"))
    assert verdict(ts.result()) == verdict(rs.result())
    same_stats()
    want = tc.check(None, THistory(burst("port")))
    assert ts.result()["valid?"] is want["valid?"] is True


def test_stream_resume_after_handle_drop(tmp_path, small_w):
    """Drop a durable handle mid-stream (only the atomically persisted
    stream.json survives) and replay the whole history through a fresh
    handle on the same path: it resumes past the checked prefix."""
    cut = 70
    for pkg in ("ref", "port"):
        p = str(tmp_path / pkg / "stream.json")
        sc = stream(pkg, path=p)
        sc.append(burst(pkg, rounds=2)[:cut])
        assert os.path.exists(p)
    reset_all()
    r = drive("ref", [burst("ref", rounds=2)],
              path=str(tmp_path / "ref" / "stream.json"))
    t = drive("port", [burst("port", rounds=2)],
              path=str(tmp_path / "port" / "stream.json"))
    assert t[0] == r[0] and verdict(t[1]) == verdict(r[1])
    st = same_stats()
    assert t[2].resumed and t[1]["streaming"]["resumed"] is True
    assert st[0]["resumes"] == 1 and st[0]["invalidations"] == 0
    assert 0 < st[0]["tail_steps"] < t[0][-1]["checked_steps"]


def test_prefix_rewrite_invalidates_to_cold(small_w):
    """A rewritten checked prefix restarts from step 0."""
    reset_all()
    outs = {}
    for pkg in ("ref", "port"):
        ops = OPS[pkg]
        a, b = burst(pkg), burst(pkg)
        b[0] = ops.invoke_op(0, "write", 2)
        b[1] = ops.ok_op(0, "write", 2)
        sc = stream(pkg)
        sc.append(a)
        sc._ops = list(b)
        outs[pkg] = (status(sc.append(bad_read_tail(pkg))), sc.result())
    assert outs["port"][0] == outs["ref"][0]
    assert verdict(outs["port"][1]) == verdict(outs["ref"][1])
    st = same_stats()
    assert st[0]["invalidations"] == 1
    assert outs["port"][1]["valid?"] is False


def test_stream_files_interchange_between_packages(tmp_path, small_w):
    """A stream file persisted by either package resumes in the other."""
    cut = 70
    for writer, reader in (("ref", "port"), ("port", "ref")):
        p = str(tmp_path / writer / "stream.json")
        stream(writer, path=p).append(burst(writer, rounds=2)[:cut])
        reset_all()
        sc = stream(reader, path=p)
        sc.append(burst(reader, rounds=2))
        assert sc.resumed and sc.result()["valid?"] is True
        assert stats(reader)[0]["resumes"] == 1


# -- coalesced tails on one plane ---------------------------------------------


def plane(pkg):
    if pkg == "ref":
        return r_dp.DispatchPlane(interpret=True, mesh=False, race=False)
    return t_dp.DispatchPlane(device="cpu")


def lockstep(pkg, chunks, hold_s, **kw):
    """Each stream on its own thread, a barrier per round; returns the
    results and the final statuses."""
    n, rounds = len(chunks), len(chunks[0])
    with plane(pkg) as pl:
        scs = [stream(pkg, plane=pl, hold_s=hold_s, **kw)
               for _ in range(n)]
        barrier = threading.Barrier(n)
        errs = []

        def run(i):
            try:
                for r in range(rounds):
                    barrier.wait(timeout=60)
                    scs[i].append(chunks[i][r])
            except Exception as e:  # noqa: BLE001 - surfaced below
                errs.append(e)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert errs == [] and not any(th.is_alive() for th in threads)
        return [sc.result() for sc in scs], [status(sc.status())
                                             for sc in scs]


def coalesced_both(make_chunks, n, rounds, hold_s):
    reset_all()
    r = lockstep("ref", make_chunks("ref"), hold_s)
    rst = stats("ref", batching=False)
    r_batches = r_dp.DISPATCH_STATS["stream_batches"]
    t_sm.reset_stream_stats()
    t_dev.reset_launch_stats()
    t_dp.reset_dispatch_stats()
    t = lockstep("port", make_chunks("port"), hold_s)
    assert t[1] == r[1]
    assert [verdict(o) for o in t[0]] == [verdict(o) for o in r[0]]
    assert stats("port", batching=False) == rst
    ds = t_dp.dispatch_stats()
    for batches in (r_batches, ds["stream_batches"]):
        assert 0 < batches <= 2 * rounds
    return t, ds


def test_coalesced_tails_stack_into_shared_launches(small_w):
    """k same-shape streams on one plane submit their tails on threads
    and the stream bucket stacks them: far fewer stacked launches than
    appends, every stream at its one-shot verdict, each frontier a
    device row between appends."""
    n, rounds = 4, 3
    (outs, _), ds = coalesced_both(
        lambda p: [[seq_chunk(p, r) for r in range(rounds)]
                   for _ in range(n)], n, rounds, hold_s=0.4)
    assert ds["stream_requests"] == n * rounds
    assert ds["stream_batches"] < n * rounds
    st = t_sm.stream_stats()
    assert st["coalesced_tails"] == n * rounds
    assert st["plane_fallbacks"] == 0
    want = oneshot("port", [op for r in range(rounds)
                            for op in seq_chunk("port", r)])
    for out in outs:
        assert out["valid?"] is want["valid?"] is True
        assert out["streaming"]["coalesced"] is True


def test_coalesced_tail_death_escalates_to_exact_parity(small_w):
    """An invalid tail on the stacked path dies at the one-shot op
    index: the fast death escalates sticky-exact through the plane."""
    n, rounds = 4, 2

    def chunks(p):
        c = [[seq_chunk(p, r) for r in range(rounds)]
             for _ in range(n)]
        c[-1][-1] = c[-1][-1] + bad_read_tail(p)
        return c

    (outs, _), _ = coalesced_both(chunks, n, rounds, hold_s=0.3)
    want = oneshot("port", [op for c in chunks("port")[-1] for op in c])
    assert outs[0]["valid?"] is True
    assert want["valid?"] is False
    assert outs[-1]["failed_op_index"] == want["failed_op_index"]
    assert t_sm.stream_stats()["escalations"] >= 1


def test_plane_fault_moves_streams_to_the_solo_chain(small_w):
    """A spent launch budget on the stream bucket fails its riders with
    the PlaneFault (no oracle arm, even on the CPU plane); each stream
    re-runs that append on its solo chain from its own frontier (a row
    of the previous stacked launch), with the verdict it would have
    had, counted in plane_fallbacks."""
    rounds = 3

    def chunks(p):
        c = [[seq_chunk(p, r) for r in range(rounds)] for _ in range(2)]
        c[-1][-1] = c[-1][-1] + bad_read_tail(p)
        return c

    t_chaos.reset_resilience()
    reset_all()
    with t_dp.DispatchPlane(device="cpu") as pl:
        scs = [t_sm.StreamingCheck(device="cpu", plane=pl)
               for _ in range(2)]
        for r in range(rounds):
            for sc, c in zip(scs, chunks("port")):
                if r == rounds - 1:
                    with t_chaos.chaos_plan(t_chaos.persistent_device_fault(
                            "cpu")):
                        sc.append(c[r])
                else:
                    sc.append(c[r])
                    assert sc._fr_dev is not None
        outs = [sc.result() for sc in scs]
    # the invalid stream's fast death escalates, and its exact re-run
    # meets the failing plane too: 3 solo chains in all
    st = t_sm.stream_stats()
    assert st["plane_fallbacks"] == st["tail_launches"] == 3
    assert st["escalations"] == 1
    res = t_chaos.resilience_snapshot()
    assert res["plane_faults"] == 3 and res["oracle_fallbacks"] == 0
    for out, c in zip(outs, chunks("port")):
        want = oneshot("port", [op for x in c for op in x])
        assert out["valid?"] is want["valid?"]
        assert out.get("failed_op_index") == want.get("failed_op_index")
    t_chaos.reset_resilience()


def test_launch_tails_takes_every_kind_of_seed(small_w):
    """launch_tails_bitset rows from None, a host [S, M] array, a host
    [1, S, M] array and a row of an earlier stacked launch: each row
    equals bitset_scan_plain on that row alone."""
    tails = []
    for r in range(4):
        ev = t_ev.history_to_events(THistory(seq_chunk("port", r)))
        tails.append(t_ev.events_to_steps(ev, W=12))
    out0, (fr_out, *_rest) = t_bs.launch_tails_bitset(
        tails, [None] * 4, S=8, device="cpu")
    seeds = [None, fr_out[1].numpy(), fr_out[2].numpy()[None], fr_out[3]]
    out, (fr, *_rest) = t_bs.launch_tails_bitset(tails, seeds, S=8,
                                                 device="cpu")
    for i, (st, seed) in enumerate(zip(tails, seeds)):
        win, meta = t_bs.pack_steps(st.padded(64))
        f0 = (t_bs.init_frontier(st.init_state, 8, 12)
              if seed is None else np.asarray(seed).reshape(8, -1))
        o, f = t_bs.bitset_scan_plain(
            torch.from_numpy(win[None]), torch.from_numpy(meta[None]),
            torch.from_numpy(np.ascontiguousarray(f0)[None]),
            "cas-register", 8, 12)
        assert torch.equal(out[i], o[0]) and torch.equal(fr[i], f[0])
    # a W12 row (128 words) seeding a W13 launch (256) is embedded in
    # the wider mask space, as a solo chain's narrower last segment
    # leaves it (the reference's reshape would raise there)
    wide = [t_bs._slice_steps(st, 0, len(st), 12) for st in tails[:2]]
    wide = [dataclasses.replace(st, W=13, **{
        k: np.pad(getattr(st, k), ((0, 0), (0, 1)))
        for k in ("occ", "f", "a", "b")}) for st in wide]
    out13, (fr13, *_rest) = t_bs.launch_tails_bitset(
        wide, [fr[0], None], S=8, device="cpu")
    win, meta = t_bs.pack_steps(wide[0].padded(64))
    o, f = t_bs.bitset_scan_plain(
        torch.from_numpy(win[None]), torch.from_numpy(meta[None]),
        torch.nn.functional.pad(fr[0][None], (0, 128)), "cas-register", 8,
        13)
    assert torch.equal(out13[0], o[0]) and torch.equal(fr13[0], f[0])


# -- windowed GC ---------------------------------------------------------------


def test_stream_gc_bounds_retained_ops(small_w):
    """gc_window set: host-side op retention stays O(window) while the
    archive and the global checked count grow; residency is one row."""
    gc_window = 64
    chunks = {p: [seq_chunk(p, r) for r in range(30)] for p in OPS}
    reset_all()
    res = {}
    for pkg in ("ref", "port"):
        sc = stream(pkg, gc_window=gc_window)
        kept, seen = 0, []
        for c in chunks[pkg]:
            seen.append(status(sc.append(c)))
            kept = max(kept, len(sc._ops))
        res[pkg] = (seen, verdict(sc.result()), sc.summary(), kept,
                    sc.device_residency())
    r, t = res["ref"], res["port"]
    assert t[:3] == r[:3] and t[3] == r[3]
    assert t[4] == r[4]
    st = same_stats()
    assert t[1]["valid?"] is True
    assert t[2]["gc_sealed_ops"] > 0 and t[3] <= gc_window + 16
    assert t[2]["retained_ops"] + t[2]["gc_sealed_ops"] == 30 * 16
    assert st[0]["gc_seals"] >= 1
    assert st[0]["gc_ops_archived"] == t[2]["gc_sealed_ops"]


def test_stream_gc_invalidation_reruns_from_step_zero_exactly(small_w):
    """A W-widening burst after GC seals dissolves the sealed frame and
    re-checks from step 0; a later bad tail dies at the GLOBAL one-shot
    op index."""
    def chunks(p):
        ops = OPS[p]
        c = [seq_chunk(p, r) for r in range(8)]
        c.append([ops.invoke_op(q, "write", q % 3) for q in range(5)]
                 + [ops.ok_op(q, "write", q % 3) for q in range(5)])
        c.append(bad_read_tail(p))
        return c

    r, t = both(chunks, gc_window=64)
    st = same_stats()
    want = oneshot("port", [op for c in chunks("port") for op in c])
    assert want["valid?"] is False
    assert t[1]["failed_op_index"] == want["failed_op_index"]
    assert st[0]["invalidations"] >= 1 and st[0]["gc_seals"] >= 1


def test_persist_batching_amortizes_saves_and_resumes(tmp_path, small_w,
                                                      monkeypatch):
    """persist_every=N: N-1 of every N verified appends skip the save,
    and a crash between boundaries resumes from the last save to the
    one-shot verdict."""
    saves = {"ref": 0, "port": 0}
    for pkg, mod in (("ref", r_sm), ("port", t_sm)):
        orig = mod.StreamingCheck._save

        def counting(self, _orig=orig, _pkg=pkg):
            saves[_pkg] += 1
            return _orig(self)

        monkeypatch.setattr(mod.StreamingCheck, "_save", counting)
    for pkg in ("ref", "port"):
        sc = stream(pkg, path=str(tmp_path / pkg / "stream.json"),
                    persist_every=4)
        for r in range(5):
            sc.append(seq_chunk(pkg, r, pairs=4))
    assert saves == {"ref": 1, "port": 1}
    r, t = both(lambda p: [[op for r in range(6)
                            for op in seq_chunk(p, r, pairs=4)]],
                persist_every=4)
    reset_all()
    outs = {}
    for pkg in ("ref", "port"):
        sc = stream(pkg, path=str(tmp_path / pkg / "stream.json"),
                    persist_every=4)
        sc.append([op for r in range(6) for op in seq_chunk(pkg, r,
                                                            pairs=4)])
        outs[pkg] = (sc.resumed, verdict(sc.result()))
    assert outs["port"] == outs["ref"] and outs["port"][0] is True
    st = same_stats()
    assert st[0]["resumes"] == 1


# -- a real SIGKILL (slow) ----------------------------------------------------

_CHILD = """
import json, os, signal, sys
sys.path.insert(0, {repo!r})
from jepsen_tpu_torch.checker.streaming import StreamingCheck
ops = [json.loads(l) for l in open({opsfile!r})]
sc = StreamingCheck(device="cpu", path={path!r})
sc.append(ops[:{cut}])
os.kill(os.getpid(), signal.SIGKILL)
"""


@pytest.mark.slow
def test_sigkill_stream_resume(tmp_path):
    """A child appends a prefix through a durable handle and is
    SIGKILLed; a fresh handle over the same stream.json resumes and
    reaches the one-shot verdict of the whole (invalid) history."""
    from jepsen_tpu_torch.store import op_to_json

    ops = THistory(burst("port", rounds=3) + bad_read_tail("port")).ops
    opsfile = str(tmp_path / "ops.jsonl")
    with open(opsfile, "w") as f:
        for op in ops:
            f.write(json.dumps(op_to_json(op)) + "\n")
    p = str(tmp_path / "stream.json")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(repo=str(REPO),
                                             opsfile=opsfile, path=p,
                                             cut=70)],
        timeout=540, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    assert proc.returncode == -signal.SIGKILL and os.path.exists(p)
    t_sm.reset_stream_stats()
    sc = t_sm.StreamingCheck(device="cpu", path=p)
    sc.append([op_to_json(op) for op in ops])
    assert sc.resumed and t_sm.stream_stats()["resumes"] == 1
    want = oneshot("port", list(ops))
    out = sc.result()
    assert out["valid?"] is want["valid?"] is False
    assert out["failed_op_index"] == want["failed_op_index"]
