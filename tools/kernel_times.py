#!/usr/bin/env python3
"""Time the PyTorch port's two CUDA kernels at the main path's shapes,
for one source tree, on one NVIDIA GPU.

    python3 tools/kernel_times.py [--root DIR] [--sweep] [--keys]

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
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

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


if __name__ == "__main__":
    sys.exit(main())
