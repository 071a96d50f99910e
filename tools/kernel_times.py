#!/usr/bin/env python3
"""Time the PyTorch port's two CUDA kernels at the main path's shapes,
for one source tree, on one NVIDIA GPU.

    python3 tools/kernel_times.py [--root DIR] [--sweep] [--keys]
    python3 tools/kernel_times.py [--root DIR] --walls [--profile]
    python3 tools/kernel_times.py [--root DIR] --graph

Imports jepsen_tpu_torch from DIR (default: the repository that holds
this script), so DIR may be an unpacked older commit (`git archive`);
its kernels build into DIR's own build/ directory. Uses only the
wrappers' public signatures, which every version of the port keeps.
Prints one JSON line: for each shape, the mean milliseconds of one
launch by CUDA events (after a warm-up launch), its return steps (the
steps before padding; us_per_step is per return step) and padded steps,
and the launch's outputs (the out row and a digest of fr_out), so two
trees can be held to the same results:

  config1      bitset_scan, config1's history 0, first segment (W=12,
               S=8, fast tier), as the main path packs it
  northstar/k  bitset_scan, segment k of the 100k-op north star's chain
               (W12..W16, S=8, fast tier), from the frontier the
               segment before it leaves
  ladder       kfrontier_scan, the ladder's valid counter (W=32, K=128)

chip_smoke.py --parent DIR runs this for DIR and for this tree in turns
(parent, change, change, parent) and compares.

--sweep (this tree only) also times kernel A at each of those shapes in
every geometry the .cu instantiates that fits it (store, warps, columns
a thread), held to the default geometry's outputs: the measurement
behind wgl_bitset.geometry()'s choice.

--keys (this tree only) also times kernel A on the key axis at BASELINE
config 2's per-key shape (W=12, S=8, 512 padded steps): config 2's
first key replicated 1, 16, 64, 128, 132, 133, 256 and 528 times (every
key the same work, so the time shows how the grid of blocks lands on
the SMs), and the real batches of 16 and 128 keys
(gen_register_history(Random(1000 + k), n_ops=625, n_procs=5,
p_crash=0.005)), each launch's outputs held equal to the one-key run.

--walls times the entry points' host walls instead of the kernels, with
only the calls every version of the port has, so two trees run in
turns can be compared: config2's 16 keys and keys_scale's 128 through
sharded.check_keys (history_to_events apart; the first call in the
process, then the median of 5), and config 1's 10 histories through
LinearizableChecker.check (median of 5 rounds), all verdicts printed.
Where the tree has them it also times the checker with sentry=False,
the history sentry's scan alone, and building a dispatch plane. With
--profile it instead runs config2's check_keys under cProfile, the
first call in the process and then 5 more, and prints each run's 15
functions of most own time (calls, own s, cumulative s).

--graph times three closures of the txn dependency graph's device
program (R = R | R @ R, ceil(log2 N) rounds, on the G1c and the G2
adjacency) on real stacks, and holds each one's per-graph counts equal
to the tree's txn_graph.graph_counts_torch:

  packed  rows as int64 words of N lanes, a round a [B, N, N, N] bool
          gather reduced with ``any`` (N <= 32 only; the reference's
          word-parallel branch as torch ops)
  f32     torch.bmm in float32, clamp_max(1)
  bf16    the same in bfloat16 (0/1 entries, only ``> 0`` read: exact)

on config6's bucket stacks (gen_txn_graph_history(Random(66),
n_txns=200_000, anomaly="g1c", cycle_len=3): buckets 4, 6, 8 and 12),
a bucket-32 stack (Random(70), 262,144 txns in groups of 32: B =
8,192), config6_wide's bucket 48 (Random(68), 48,000 txns in groups of
48) and its 1,499-txn component (Random(69)) as one solo graph. Each
row gives the mean ms by CUDA events over 5 runs after a warm-up and
the peak bytes the closure allocated beyond its inputs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--keys", action="store_true")
    ap.add_argument("--walls", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--graph", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if args.walls:
        return walls(root, args.profile)
    if args.graph:
        return graph_closures(root)

    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from jepsen_tpu_torch import sim
    from jepsen_tpu_torch.checker import events as ev_mod
    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.checker import wgl_bitset as bs
    from jepsen_tpu_torch.checker import wgl_kfrontier as kf

    assert os.path.dirname(os.path.dirname(bs.__file__)) == os.path.join(
        root, "jepsen_tpu_torch"), bs.__file__
    dev = torch.device("cuda")
    t0 = time.perf_counter()

    def cuda_ms(fn, n: int) -> float:
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n

    def digest(t) -> str:
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    def chain(ev):
        W, S = bs.plan(bs.get_model("cas-register"), ev.window,
                       len(ev.value_codes))
        steps = ev_mod.events_to_steps(ev, W=W)
        segs = bs._plan_for(steps, None)
        return steps, segs, bs._segment_args(steps, segs, dev), S

    rows, inputs = {}, {}

    def time_bitset(name, win, meta, fr_in, S, W, n_reps, n_return):
        inputs[name] = (win, meta, fr_in, S, W, n_reps, n_return)
        out, fr = bs.bitset_scan(win, meta, fr_in, "cas-register", S, W)
        ms = cuda_ms(lambda: bs.bitset_scan(win, meta, fr_in, "cas-register",
                                            S, W), n_reps)
        rows[name] = {"kernel": "bitset_scan", "W": W, "S": S,
                      "steps": win.shape[1] // (4 * W),
                      "return_steps": n_return, "ms": ms,
                      "us_per_step": 1e3 * ms / n_return,
                      "out": out[0, 0].tolist(), "fr_out": digest(fr)}
        return fr

    # config1: history 0, first segment
    h = sim.gen_register_history(random.Random(100), n_ops=1000, n_procs=5,
                                 p_crash=0.01)
    steps, segs, args_, S = chain(ev_mod.history_to_events(h))
    (win, meta), (start, end, W) = args_[0], segs[0]
    time_bitset("config1", win, meta, bs._fr0(steps.init_state, S, W, dev),
                S, W, 20, end - start)

    # the north star's chain, segment by segment
    h = sim.gen_register_history(random.Random(9), n_ops=100_000, n_procs=5,
                                 p_crash=0.0002)
    steps, segs, args_, S = chain(ev_mod.history_to_events(h))
    fr = bs._fr0(steps.init_state, S, segs[0][2], dev)
    for k, ((win, meta), (start, end, W)) in enumerate(zip(args_, segs)):
        fr_in = bs._reshape_frontier(fr, bs.bitset_words(W))
        fr = time_bitset(f"northstar/{k}", win, meta, fr_in, S, W, 3,
                         end - start)

    # the ladder's valid counter at K=128
    h = sim.gen_cas_counter_history(random.Random(5), n_rounds=40, n_procs=24)
    ev = ev_mod.history_to_events(h)
    W = lin._bucket_window(max(ev.window, 1))
    st = ev_mod.events_to_steps(ev, W=W)
    ki = lin.get_model("cas-register").kernel_init_code(ev.init_state)
    st = dataclasses.replace(st, init_state=ki)
    n_return = len(st)
    st = st.padded(ev_mod.bucket(max(len(st), 1), 64))
    win, meta = kf._dev_args(st, dev)
    out = kf.kfrontier_scan(win, meta, "cas-register", 128, W)
    ms = cuda_ms(lambda: kf.kfrontier_scan(win, meta, "cas-register", 128, W),
                 5)
    rows["ladder"] = {"kernel": "kfrontier_scan", "W": W, "K": 128,
                      "steps": win.shape[1], "return_steps": n_return,
                      "ms": ms, "us_per_step": 1e3 * ms / n_return,
                      "out": out[0, 0].tolist()}

    sweep = []
    if args.sweep:
        for name, (win, meta, fr_in, S, W, n_reps, n_return) in inputs.items():
            M = bs.bitset_words(W)
            default = bs.geometry(W, S)
            want = bs._launch(win, meta, fr_in, "cas-register", S, W, False,
                              default)
            for store_i, r, cols in bs.INSTANCES:
                store, warps = bs.STORES[store_i], M // (32 * cols)
                if r not in (0, S) or 32 * warps * cols != M or not (
                        1 <= warps <= bs.max_warps(store, S, cols)):
                    continue
                geo = bs.Geometry(store, warps, cols, W, S)
                if not bs._fits(geo):
                    continue
                got = bs._launch(win, meta, fr_in, "cas-register", S, W,
                                 False, geo)
                same = (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1]))
                ms = cuda_ms(lambda: bs._launch(
                    win, meta, fr_in, "cas-register", S, W, False, geo),
                    n_reps)
                sweep.append(dict(shape=name, W=W, store=store, warps=warps,
                                  cols=cols, ms=ms,
                                  us_per_step=1e3 * ms / n_return,
                                  default=geo == default, same=same))
    keys = []
    if args.keys:
        import numpy as np

        def packed(n_keys):
            hists = [sim.gen_register_history(
                random.Random(1000 + k), n_ops=625, n_procs=5,
                p_crash=0.005) for k in range(n_keys)]
            return [ev_mod.events_to_steps(ev_mod.history_to_events(h),
                                           W=12) for h in hists]

        def stacked(steps_list):
            n = ev_mod.bucket(max(len(st) for st in steps_list), 64)
            pk = [bs.pack_steps(st.padded(n)) for st in steps_list]
            return (
                torch.from_numpy(np.stack([w for w, _ in pk])).to(dev),
                torch.from_numpy(np.stack([m for _, m in pk])).to(dev),
                torch.from_numpy(np.stack([bs.init_frontier(
                    st.init_state, 8, 12) for st in steps_list])).to(dev))

        real = packed(128)
        one = stacked(real[:1])
        base = bs.bitset_scan(*one, "cas-register", 8, 12)
        cases = [(f"replicated x{n}", [real[0]] * n)
                 for n in (1, 16, 64, 128, 132, 133, 256, 528)]
        cases += [("config2 (16 keys)", real[:16]),
                  ("keys_scale (128 keys)", real)]
        for name, steps_list in cases:
            args3 = stacked(steps_list)
            out, fr = bs.bitset_scan(*args3, "cas-register", 8, 12)
            same = name.startswith("replicated") and bool(
                (out == base[0][0]).all() and (fr == base[1][0]).all())
            ms = cuda_ms(lambda: bs.bitset_scan(*args3, "cas-register", 8,
                                                12), 20)
            keys.append(dict(case=name, keys=len(steps_list),
                             steps=args3[0].shape[1] // (4 * 12),
                             return_steps=sum(len(st) for st in steps_list),
                             ms=ms, same_as_one_key=same))
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0),
                      "seconds": time.perf_counter() - t0, "shapes": rows,
                      **({"sweep": sweep} if args.sweep else {}),
                      **({"keys": keys} if args.keys else {})}),
          flush=True)
    if sweep and not all(r["same"] for r in sweep):
        print("kernel_times: a geometry disagrees with the default",
              file=sys.stderr)
        return 1
    if any(r["case"].startswith("replicated") and not r["same_as_one_key"]
           for r in keys):
        print("kernel_times: a replicated key disagrees with one key",
              file=sys.stderr)
        return 1
    return 0


def walls(root: str, profile: bool = False) -> int:
    import cProfile
    import inspect
    import pstats
    import statistics

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from jepsen_tpu_torch import sim
    from jepsen_tpu_torch.checker import events as ev_mod
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.checker.sharded import check_keys

    t_start = time.perf_counter()
    out = {"root": root, "device": torch.cuda.get_device_name(0)}

    def timed(fn):
        t0 = time.perf_counter()
        r = fn()
        return time.perf_counter() - t0, r

    config1 = [sim.gen_register_history(random.Random(100 + i), n_ops=1000,
                                        n_procs=5, p_crash=0.01)
               for i in range(8)]
    config1 += [sim.corrupt_history(config1[i], random.Random(200 + i))
                for i in range(2)]
    params = inspect.signature(LinearizableChecker).parameters
    kw = {"race": False} if "race" in params else {}
    checker = LinearizableChecker("cas-register", **kw)
    # warm-up: CUDA, the kernels' build and load, the sequential path
    checker.check(None, config1[0])

    def top(fn, n: int):
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(n):
            fn()
        prof.disable()
        st = pstats.Stats(prof).stats
        rows = sorted(st.items(), key=lambda kv: -kv[1][2])[:15]
        return [[f"{os.path.basename(f)}:{line}({fn_name})", nc, tt, ct]
                for (f, line, fn_name), (_, nc, tt, ct, _) in rows]

    if profile:
        hists = [sim.gen_register_history(random.Random(1000 + k),
                                          n_ops=625, n_procs=5,
                                          p_crash=0.005) for k in range(16)]
        evs = [ev_mod.history_to_events(h) for h in hists]
        out["profile_config2_first"] = top(lambda: check_keys(evs), 1)
        out["profile_config2_warm_x5"] = top(lambda: check_keys(evs), 5)
        print(json.dumps(out), flush=True)
        return 0

    for name, n_keys in (("config2", 16), ("keys_scale", 128)):
        hists = [sim.gen_register_history(random.Random(1000 + k),
                                          n_ops=625, n_procs=5,
                                          p_crash=0.005)
                 for k in range(n_keys)]
        ev_s, evs = timed(lambda: [ev_mod.history_to_events(h)
                                   for h in hists])
        first_s, res = timed(lambda: check_keys(evs))
        warm = [timed(lambda: check_keys(evs))[0] for _ in range(5)]
        out[name] = {"history_to_events_s": ev_s,
                     "check_keys_first_s": first_s,
                     "check_keys_s": statistics.median(warm),
                     "check_keys_runs_s": warm,
                     "valid": [r["valid?"] for r in res]}

    def config1_round(c):
        rows = [c.check(None, h) for h in config1]
        return sum(r["wall_s"] for r in rows), rows

    rounds = [config1_round(checker) for _ in range(5)]
    out["config1"] = {
        "wall_s": statistics.median(w for w, _ in rounds),
        "runs_s": [w for w, _ in rounds],
        "verdicts": [[r["valid?"], r.get("failed_op_index")]
                     for r in rounds[0][1]]}
    if "sentry" in params:
        bare = LinearizableChecker("cas-register", sentry=False, **kw)
        rounds = [config1_round(bare) for _ in range(5)]
        out["config1"]["sentry_off_wall_s"] = statistics.median(
            w for w, _ in rounds)
        from jepsen_tpu_torch.history.sentry import validate_history

        scans = [timed(lambda: [validate_history(h) for h in config1])[0]
                 for _ in range(5)]
        out["config1"]["sentry_scan_s"] = statistics.median(scans)
    try:
        from jepsen_tpu_torch.checker import dispatch
    except ImportError:
        dispatch = None
    if dispatch is not None:
        builds = []
        for _ in range(5):
            t, plane = timed(lambda: dispatch.DispatchPlane())
            plane.close()
            builds.append(t)
        out["plane_build_s"] = statistics.median(builds)
    out["seconds"] = time.perf_counter() - t_start
    print(json.dumps(out), flush=True)
    return 0


def graph_closures(root: str) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from jepsen_tpu_torch import sim
    from jepsen_tpu_torch.checker import txn_graph as tg

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def packed(a, n_iters):
        N = a.shape[-1]
        lanes = torch.arange(N, dtype=torch.int64, device=a.device)
        pw = torch.ones_like(lanes) << lanes

        def pack(bits):
            return torch.where(bits, pw, 0).sum(-1)

        def unpack(C):
            return ((C[:, :, None] >> lanes) & 1) > 0

        R = pack(a > 0.5)
        for _ in range(n_iters):
            edge = unpack(R)
            R = R | pack((edge[:, :, :, None] & edge[:, None, :, :]).any(2))
        return unpack(R)

    def matmul(dtype):
        def closure(a, n_iters):
            a = a.to(dtype)
            for _ in range(n_iters):
                a = (a + torch.bmm(a, a)).clamp_max(1.0)
            return a > 0
        return closure

    closures = {"packed": packed, "f32": matmul(torch.float32),
                "bf16": matmul(torch.bfloat16)}

    def counts(closure, wrww, allm, rw, n_iters):
        c1, c2 = closure(wrww, n_iters), closure(allm, n_iters)
        return (torch.diagonal(c1, dim1=1, dim2=2).sum(-1).to(torch.int32),
                (rw & c1.transpose(1, 2)).sum((-2, -1)).to(torch.int32),
                (rw & c2.transpose(1, 2)).sum((-2, -1)).to(torch.int32))

    def cuda_ms(fn, n: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n

    def bucket_stacks(h, buckets=None):
        es = tg.extract_edges(tg.encode_txn_graph(h))
        chk = tg.TxnGraphChecker(buckets=buckets, device="cpu")
        prog = chk._compile_graph_prog(es, True, True, dev)
        return [p[:3] for p in prog["payloads"]], es

    stacks = {}
    got, _ = bucket_stacks(sim.gen_txn_graph_history(
        random.Random(66), n_txns=200_000, anomaly="g1c", cycle_len=3))
    for s in got:
        stacks.setdefault(f"config6/N{s[0].shape[-1]}", s)
    got, _ = bucket_stacks(sim.gen_txn_graph_history(
        random.Random(70), n_txns=262_144, txns_per_group=32), (32,))
    stacks["groups32/N32"] = got[0]
    got, _ = bucket_stacks(sim.gen_txn_graph_history(
        random.Random(68), n_txns=48_000, txns_per_group=48,
        anomaly="g2-item", cycle_len=3), (48,))
    stacks["config6_wide/N48"] = got[0]
    _, es = bucket_stacks(sim.gen_txn_graph_history(
        random.Random(69), n_txns=1500, keys_per_group=8,
        txns_per_group=1500, anomaly="g1c", cycle_len=4), (4,))
    labels, _ = tg._weak_components(es.n_txns,
                                    tg._pairs(es.wr, es.ww, es.rw))
    comp = int(np.bincount(labels).argmax())
    nodes = np.nonzero(labels == comp)[0]
    stacks[f"config6_wide/solo{len(nodes)}"] = [
        torch.as_tensor(m[None], device=dev)
        for m in tg._sub_edge_matrices(es, nodes, labels, comp, len(nodes))]

    rows, same = [], True
    for name, (wrww, allm, rw) in stacks.items():
        B, N = int(wrww.shape[0]), int(wrww.shape[-1])
        n_iters = tg._n_iters(N)
        want = tg.graph_counts_torch(wrww, allm, rw, n_iters, True, True)
        row = {"stack": name, "B": B, "N": N, "rounds": 2 * n_iters}
        for cname, closure in closures.items():
            if cname == "packed" and N > 32:
                continue
            out = counts(closure, wrww, allm, rw, n_iters)
            ok = all(torch.equal(o, w) for o, w in zip(out, want))
            same &= ok
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: counts(closure, wrww, allm, rw, n_iters))
            row[cname] = {"ms": ms, "same": ok,
                          "peak_bytes": torch.cuda.max_memory_allocated()
                          - base}
        rows.append(row)
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0),
                      "seconds": time.perf_counter() - t_start,
                      "graph": rows}), flush=True)
    if not same:
        print("kernel_times: a graph closure disagrees with "
              "graph_counts_torch", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
