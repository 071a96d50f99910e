#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (jepsen_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Phases, in order; each prints one JSON line with its seconds, and any
failure raises (non-zero exit, no result line):

  device     require CUDA; print nvidia-smi's name and power limit
  build      nvcc every kernel from csrc/ (one process per source)
  kernels    each kernel against its plain PyTorch version on the card,
             bit-exact: small cases over W, S, K, tiers and frontier
             stores, and config1's and the ladder's own inputs as the
             main path builds them; time both with CUDA events beside
             the bound
  config1    8 x 1k-op CAS-register histories + 2 corrupted copies
  ladder     a contended-CAS-counter history of window 24 (K-frontier
             ladder) + a corrupted copy
  northstar  the 100k-op CAS-register history, one host sync
  northstar_parity
             every segment of the north star's chain against the plain
             version, bit-exact; kernel A timed at each segment's shape
  compare    only with --parent DIR (an unpacked older commit, e.g.
             `git archive <commit> | tar -x -C build/parent`):
             tools/kernel_times.py for DIR and for this tree in turns
             (parent, change, change, parent), same outputs required

The kernels' launch counters are set to 0 before config1 and read right
after northstar's end-to-end check: both kernels must have launched on
that main path. Kernel A's times in the kernels line are means per launch
over those launches' shapes (config1's launches at config1's shape, one
launch per north-star segment), so its launches and its times refer to
the same work; "by_shape" lists each shape. The line
before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Exits non-zero without CUDA, and where the
package is missing (a directory holding only this script).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import re
import subprocess
import sys
import time

import numpy as np
import torch

#: H100 SXM published HBM rate (NVIDIA data sheet, 700 W), bytes/s
HBM_BYTES_S = 3.35e12
#: 32-bit integer and logic operations per SM per clock on Hopper (64
#: INT32 lanes per SM); the peak is this times the SM count times the
#: card's maximum SM clock, set in the device phase
INT32_OPS_PER_SM_CLK = 64
INT32_OPS_S = 0.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Phase:
    """Times a phase and prints its JSON line on success."""

    def __init__(self, name: str):
        self.name = name
        self.info: dict = {}

    def __enter__(self):
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self.info

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            torch.cuda.synchronize()
            emit({"phase": self.name,
                  "seconds": time.perf_counter() - self.t0, **self.info})
        return False


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events, after
    one warm-up run; reps=0 times the one run itself."""
    if reps == 0:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / INT32_OPS_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def abs_err(a, b) -> int:
    """Largest |a - b| over two int32 tensors, taken in int64."""
    return int((a.long() - b.long()).abs().max())


def ptxas_summary(log: str) -> dict:
    """nvcc -Xptxas -v output by kernel instance: registers, stack frame
    and spill bytes. A bitset_scan instance is keyed "store,rows,cols"
    (its template arguments); a plain kernel by its name."""
    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            t = re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)E", m.group(1))
            key = ",".join(t.groups()) if t else m.group(1)
            out[key] = {}
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[key].update(stack_bytes=int(m.group(1)),
                            spill_bytes=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[key]["registers"] = int(m.group(1))
    return out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- kernel A: bitset_scan ---------------------------------------------------


def bitset_inputs(steps, S: int, dev):
    from jepsen_tpu_torch.checker import wgl_bitset as bs

    win, meta = bs.pack_steps(steps)
    fr0 = bs.init_frontier(steps.init_state, S, steps.W)[None]
    return (torch.from_numpy(win[None]).to(dev),
            torch.from_numpy(meta[None]).to(dev),
            torch.from_numpy(fr0).to(dev))


def bitset_bound(win, meta, fr_in, out, S: int, W: int, model: str):
    """(ms, bound_by) for one fast-tier scan of these inputs: each input
    read once and each output written once, against the word operations
    the inputs need (per applied slot: the source words, OR-ed over S
    rows for a write, plus the OR into the destination; per live step
    the RETURN filter's S*M words), counted up to the death step."""
    from jepsen_tpu_torch.checker import wgl_bitset as bs
    from jepsen_tpu_torch.checker.models import model as get_model

    M = bs.bitset_words(W)
    w = win.cpu().numpy().reshape(-1, 4, W).astype(np.int64)
    m = meta.cpu().numpy().reshape(-1, bs.META_COLS)
    died = int(out.cpu().numpy()[0, 0, 2])
    isu, _, _, valid = (
        t.numpy() for t in get_model(model).bitset_slot(
            torch.from_numpy(w[:, 1]), torch.from_numpy(w[:, 2]),
            torch.from_numpy(w[:, 3]))
    )
    words = np.array([M if s < 5 else M // 2 for s in range(W)])
    per_slot = words * np.where(isu, S + 1, 2)  # [n, W]
    ops = 0
    for i in range(len(m)):
        slot, live, opidx, fresh = (int(x) for x in m[i])
        if live != 1:
            continue
        if fresh:
            fbits = (fresh >> np.arange(W)) & 1
            ops += int((per_slot[i] * (fbits & valid[i])).sum())
            ops += 2 * int((per_slot[i] * (w[i, 0] & valid[i])).sum())
        ops += S * M
        if opidx == died:
            break
    nbytes = (win.numel() + 4 * meta.numel() + 2 * 4 * fr_in.numel()
              + 4 * out.numel())
    return bound(nbytes, ops)


def kernel_a_parity(dev, sim, ev_mod, bs) -> dict:
    """bitset_scan against bitset_scan_plain on the card: W in
    {12, 16, 17, 19}, S in {8, 32}, a valid and a dying history, both
    tiers, and every frontier store (registers, shared, global) that
    fits the shape. Exact equality of out and fr_out."""
    cases = 0
    max_err = 0
    placements_run = set()
    for W in (12, 16, 17, 19):
        for S in (8, 32):
            nv = 5 if S == 8 else 24
            h = sim.gen_register_history(
                random.Random(1000 + W * 10 + S), n_ops=64, n_procs=W,
                n_values=nv, p_crash=0.0)
            hc = sim.corrupt_history(h, random.Random(7 + W), n_values=nv)
            for hist in (h, hc):
                ev = ev_mod.history_to_events(hist)
                check(ev.window <= W, f"window {ev.window} > W={W}")
                steps = ev_mod.events_to_steps(ev, W=W)
                steps = steps.padded(ev_mod.bucket(max(len(steps), 1), 64))
                win, meta, fr0 = bitset_inputs(steps, S, dev)
                stores = []
                for placement in bs.STORES:
                    try:
                        bs.geometry(W, S, placement)
                        stores.append(placement)
                    except ValueError:
                        pass
                for exact in (False, True):
                    o_p, f_p = bs.bitset_scan_plain(
                        win, meta, fr0, "cas-register", S, W, exact=exact)
                    for placement in stores:
                        o_k, f_k = bs.bitset_scan(
                            win, meta, fr0, "cas-register", S, W,
                            exact=exact, placement=placement)
                        torch.cuda.synchronize()
                        err = max(abs_err(o_k, o_p), abs_err(f_k, f_p))
                        max_err = max(max_err, err)
                        check(err == 0, f"bitset_scan != plain at W={W} "
                              f"S={S} exact={exact} {placement}: "
                              f"{o_k.tolist()} vs {o_p.tolist()}")
                        placements_run.add(placement)
                        cases += 1
    check(placements_run == set(bs.STORES), "every store ran")
    return {"cases": cases, "max_abs_err": max_err, "tolerance": 0}


# -- kernel B: kfrontier_scan ------------------------------------------------


def kfrontier_inputs(steps, dev):
    from jepsen_tpu_torch.checker import wgl_kfrontier as kf

    win, meta = kf.pack_steps(steps)
    return (torch.from_numpy(win[None]).to(dev),
            torch.from_numpy(meta[None]).to(dev))


def kfrontier_bound(win, meta, out, K: int, W: int):
    """(ms, bound_by): inputs read and the verdict written once, against
    one operation per candidate and per table entry in every closure
    round the run took (out[5])."""
    rounds = int(out.cpu().numpy()[0, 0, 5])
    ops = rounds * (W * K + K)
    nbytes = 4 * (win.numel() + meta.numel() + out.numel())
    return bound(nbytes, ops)


def kernel_b_parity(dev, sim, ev_mod, kf) -> dict:
    """kfrontier_scan against kfrontier_scan_plain on the card: K in
    {128, 256} x W in {8, 16, 32} where the reference's _pallas_ok
    admits it, on crash-bearing, dying, wide (slot 31, a negative
    slotbit) and overflowing histories. Exact equality of out."""
    from jepsen_tpu_torch.checker.linearizable import _pallas_ok

    hists = {
        8: [sim.gen_register_history(random.Random(21), n_ops=80,
                                     n_procs=4, p_crash=0.05)],
        16: [sim.gen_register_history(random.Random(22), n_ops=80,
                                      n_procs=5, p_crash=0.1),
             # fourteen concurrent clients: overflows K=128 and K=256
             sim.gen_register_history(random.Random(23), n_ops=80,
                                      n_procs=14, p_crash=0.0)],
        32: [sim.gen_cas_counter_history(random.Random(24), n_rounds=4,
                                         n_procs=32)],
    }
    cases, max_err, overflowed, died = 0, 0, False, False
    for W, hs in hists.items():
        nv = 33 if W == 32 else 3
        for h in list(hs):
            hs.append(sim.corrupt_history(h, random.Random(W), n_values=nv))
        for h in hs:
            ev = ev_mod.history_to_events(h)
            check(ev.window <= W, f"window {ev.window} > W={W}")
            steps = ev_mod.events_to_steps(ev, W=W)
            win, meta = kfrontier_inputs(steps, dev)
            for K in (128, 256):
                if not _pallas_ok(K, W, 1):
                    continue
                o_p = kf.kfrontier_scan_plain(win, meta, "cas-register", K, W)
                o_k = kf.kfrontier_scan(win, meta, "cas-register", K, W)
                torch.cuda.synchronize()
                err = abs_err(o_k, o_p)
                max_err = max(max_err, err)
                check(err == 0, f"kfrontier_scan != plain at K={K} W={W}: "
                      f"{o_k.tolist()} vs {o_p.tolist()}")
                overflowed |= bool(o_k[0, 0, 1])
                died |= not bool(o_k[0, 0, 0])
                cases += 1
    check(overflowed, "an overflow case ran")
    check(died, "a dying case ran")
    return {"cases": cases, "max_abs_err": max_err, "tolerance": 0}


# -- parity at the main path's own inputs ------------------------------------


def bitset_chain(ev, dev, bs):
    """The main path's bitset-tier inputs for an event stream, built as
    check_events_bucketed builds them: (steps, segments, per-segment
    (win, meta) on the card, S)."""
    from jepsen_tpu_torch.checker.events import events_to_steps

    W, S = bs.plan(bs.get_model("cas-register"), ev.window,
                   len(ev.value_codes))
    steps = events_to_steps(ev, W=W)
    segs = bs._plan_for(steps, None)
    return steps, segs, bs._segment_args(steps, segs, dev), S


def bitset_chain_parity(ev, dev, bs, exact: bool, timed: bool = False):
    """Run the main path's segment chain for ev through bitset_scan and
    hold every segment's out and fr_out against bitset_scan_plain on the
    same inputs (each segment's fr_in is the previous segment's fr_out
    moved into its mask space, as _run_chain does). Exact equality.
    timed: also time each segment's kernel (CUDA events, 3 launches)
    and plain version (one call), with its bound, into "by_shape"."""
    steps, segs, args, S = bitset_chain(ev, dev, bs)
    fr = bs._fr0(steps.init_state, S, segs[0][2], dev)
    max_err, n_steps, by_shape = 0, 0, []
    for (win, meta), (start, end, W) in zip(args, segs):
        fr_in = bs._reshape_frontier(fr, bs.bitset_words(W))
        o_k, f_k = bs.bitset_scan(win, meta, fr_in, "cas-register", S, W,
                                  exact=exact)
        plain = []
        plain_ms = cuda_ms(lambda: plain.append(bs.bitset_scan_plain(
            win, meta, fr_in, "cas-register", S, W, exact=exact)), reps=0)
        o_p, f_p = plain[-1]
        err = max(abs_err(o_k, o_p), abs_err(f_k, f_p))
        check(err == 0, f"bitset_scan != plain on the main path's segment "
              f"{start}:{end} W={W} S={S} exact={exact}: "
              f"{o_k.tolist()} vs {o_p.tolist()}")
        max_err = max(max_err, err)
        n = win.shape[1] // (4 * W)
        n_steps += n
        if timed:  # per return step: the segment's steps before padding
            ms = cuda_ms(lambda: bs.bitset_scan(
                win, meta, fr_in, "cas-register", S, W, exact=exact), reps=3)
            b_ms, b_by = bitset_bound(win, meta, fr_in, o_k, S, W,
                                      "cas-register")
            geo = bs.geometry(W, S)
            by_shape.append(dict(
                W=W, S=S, steps=n, return_steps=end - start, ms=ms,
                us_per_step=1e3 * ms / (end - start),
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                geometry=f"{geo.store} warps={geo.warps} cols={geo.cols}"))
        fr = f_k
    return {"segments": [list(s) for s in segs], "S": S, "exact": exact,
            "steps": n_steps, "max_abs_err": max_err, "by_shape": by_shape}


def kfrontier_main_inputs(ev, dev, kf):
    """The ladder's kernel-B inputs for ev, built as check_events_bucketed
    builds them: (win, meta, W, return steps before padding)."""
    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.checker.events import bucket, events_to_steps

    W = lin._bucket_window(max(ev.window, 1))
    steps = events_to_steps(ev, W=W)
    ki = lin.get_model("cas-register").kernel_init_code(ev.init_state)
    steps = dataclasses.replace(steps, init_state=ki)
    n_return = len(steps)
    steps = steps.padded(bucket(max(len(steps), 1), 64))
    win, meta = kf._dev_args(steps, dev)
    return win, meta, W, n_return


def compare_with_parent(parent: str) -> dict:
    """tools/kernel_times.py for the parent tree and this one, in turns
    (parent, change, change, parent), each in its own process; every
    shape's outputs must agree. Per shape: both trees' mean ms (the mean
    of their two runs) and the parent/change ratio."""
    here = os.path.dirname(os.path.abspath(__file__))
    tool = os.path.join(here, "tools", "kernel_times.py")
    runs = []
    for root in (parent, here, here, parent):
        proc = subprocess.run(
            [sys.executable, tool, "--root", root], capture_output=True,
            text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"kernel_times.py --root {root} failed:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    rows = {}
    for name, ref in runs[0]["shapes"].items():
        for r in runs[1:]:
            got = r["shapes"][name]
            check(got["out"] == ref["out"]
                  and got.get("fr_out") == ref.get("fr_out"),
                  f"{name}: parent and change disagree: {got} vs {ref}")
        p_ms = [runs[0]["shapes"][name]["ms"], runs[3]["shapes"][name]["ms"]]
        c_ms = [runs[1]["shapes"][name]["ms"], runs[2]["shapes"][name]["ms"]]
        steps = ref["return_steps"]
        rows[name] = dict(
            kernel=ref["kernel"], W=ref["W"], return_steps=steps,
            parent_ms=p_ms, change_ms=c_ms,
            parent_us_per_step=1e3 * sum(p_ms) / 2 / steps,
            change_us_per_step=1e3 * sum(c_ms) / 2 / steps,
            speedup=sum(p_ms) / sum(c_ms))
    return {"parent": parent, "order": "parent, change, change, parent",
            "run_seconds": [r["seconds"] for r in runs], "shapes": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked older tree to time the "
                    "kernels against (compare phase)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    from jepsen_tpu_torch import launch_stats_snapshot, reset_launch_stats
    from jepsen_tpu_torch import sim
    from jepsen_tpu_torch.checker import _build
    from jepsen_tpu_torch.checker import events as ev_mod
    from jepsen_tpu_torch.checker import wgl_bitset as bs
    from jepsen_tpu_torch.checker import wgl_kfrontier as kf
    from jepsen_tpu_torch.checker.linearizable import (
        LinearizableChecker,
        check_events_bucketed,
    )
    from jepsen_tpu_torch.checker.wgl_oracle import check_events

    dev = torch.device("cuda")
    smi = "not measured"

    with Phase("device") as info:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        max_sm_mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0])
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        global INT32_OPS_S
        INT32_OPS_S = n_sm * INT32_OPS_PER_SM_CLK * max_sm_mhz * 1e6
        info.update(nvidia_smi=smi, torch=torch.__version__,
                    cuda=torch.version.cuda,
                    name=torch.cuda.get_device_name(0),
                    sms=n_sm, max_sm_mhz=max_sm_mhz,
                    int32_ops_s=INT32_OPS_S)

    with Phase("build") as info:
        log = _build.build_all()
        info["kernels"] = {
            name: {"seconds": entry["seconds"],
                   "ptxas": ptxas_summary(entry["ptxas"])}
            for name, entry in log.items()
        }
        # the instances the main path runs must not spill
        main_geos = {bs.geometry(W, 8) for W in range(12, 17)}
        for geo in main_geos:
            key = f"{bs.STORES.index(geo.store)},"
            key += f"{geo.S if geo.store == 'registers' else 0},{geo.cols}"
            got = info["kernels"]["bitset_scan"]["ptxas"].get(key)
            check(got is not None and got["spill_bytes"] == 0,
                  f"bitset_scan instance {key} ({geo}) spills: {got}")

    # -- kernels: parity and timing at the main path's shapes --------------
    timing = {}
    with Phase("kernels") as info:
        parity = {
            "bitset_scan": kernel_a_parity(dev, sim, ev_mod, bs),
            "kfrontier_scan": kernel_b_parity(dev, sim, ev_mod, kf),
        }
        info.update(parity)

        # kernel A on config1's inputs, built as the main path builds
        # them: history 0 and its corrupted copy (which escalates to
        # the exact tier), every segment held against the plain version
        h = sim.gen_register_history(random.Random(100), n_ops=1000,
                                     n_procs=5, p_crash=0.01)
        hc = sim.corrupt_history(h, random.Random(200))
        main_a = [
            bitset_chain_parity(ev_mod.history_to_events(x), dev, bs, exact)
            for x, exact in ((h, False), (hc, False), (hc, True))
        ]
        # timed on history 0's first segment, fast tier
        steps, segs, args, S = bitset_chain(ev_mod.history_to_events(h),
                                            dev, bs)
        (win, meta), (start, end, W) = args[0], segs[0]
        fr0 = bs._fr0(steps.init_state, S, W, dev)
        out, fr = bs.bitset_scan(win, meta, fr0, "cas-register", S, W)
        ms = cuda_ms(lambda: bs.bitset_scan(win, meta, fr0, "cas-register",
                                            S, W), reps=20)
        plain = []
        plain_ms = cuda_ms(lambda: plain.append(bs.bitset_scan_plain(
            win, meta, fr0, "cas-register", S, W)), reps=0)
        err_a = max(abs_err(out, o) + abs_err(fr, f) for o, f in plain)
        check(err_a == 0, "bitset_scan != plain at the timed shape")
        b_ms, b_by = bitset_bound(win, meta, fr0, out, S, W, "cas-register")
        n = win.shape[1] // (4 * W)
        geo = bs.geometry(W, S)
        timing["bitset_scan"] = dict(
            W=W, S=S, steps=n, return_steps=end - start, ms=ms,
            us_per_step=1e3 * ms / (end - start),
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            geometry=f"{geo.store} warps={geo.warps} cols={geo.cols}")

        # kernel B on the ladder's inputs, built as the main path builds
        # them (the contended counter and its corrupted copy, K=128, the
        # rung both take), held against the plain version
        h = sim.gen_cas_counter_history(random.Random(5), n_rounds=40,
                                        n_procs=24)
        hc = sim.corrupt_history(h, random.Random(6), n_values=25)
        main_b = []
        for x in (hc, h):
            win, meta, W, n_return = kfrontier_main_inputs(
                ev_mod.history_to_events(x), dev, kf)
            out = kf.kfrontier_scan(win, meta, "cas-register", 128, W)
            plain = []
            # the valid counter (last) is the timed one
            plain_ms = cuda_ms(lambda: plain.append(kf.kfrontier_scan_plain(
                win, meta, "cas-register", 128, W)), reps=0)
            err = max(abs_err(out, o) for o in plain)
            check(err == 0, f"kfrontier_scan != plain on the ladder's "
                  f"inputs: {out.tolist()} vs {plain[0].tolist()}")
            main_b.append({"W": W, "K": 128, "steps": win.shape[1],
                           "max_abs_err": err})
        ms = cuda_ms(lambda: kf.kfrontier_scan(win, meta, "cas-register",
                                               128, W), reps=20)
        b_ms, b_by = kfrontier_bound(win, meta, out, 128, W)
        timing["kfrontier_scan"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            us_per_step=1e3 * ms / n_return,
            shape=f"W={W} K=128 steps={win.shape[1]} (return steps "
                  f"{n_return}) keys=1")
        info.update(timing=timing, main_path_parity={
            "bitset_scan": main_a, "kfrontier_scan": main_b})
        parity["bitset_scan"]["max_abs_err"] = max(
            [parity["bitset_scan"]["max_abs_err"], err_a]
            + [c["max_abs_err"] for c in main_a])
        parity["kfrontier_scan"]["max_abs_err"] = max(
            [parity["kfrontier_scan"]["max_abs_err"]]
            + [c["max_abs_err"] for c in main_b])

    # -- the main path: counts from 0 -----------------------------------------
    bs.bitset_scan.launches = 0
    kf.kfrontier_scan.launches = 0
    checker = LinearizableChecker("cas-register")
    a_launches = {}  # kernel A's main-path launches by phase

    with Phase("config1") as info:
        hists = [
            sim.gen_register_history(random.Random(100 + i), n_ops=1000,
                                     n_procs=5, p_crash=0.01)
            for i in range(8)
        ]
        hists += [sim.corrupt_history(hists[i], random.Random(200 + i))
                  for i in range(2)]
        reset_launch_stats()
        rows = [checker.check(None, h) for h in hists]
        stats = launch_stats_snapshot()
        a_launches["config1"] = bs.bitset_scan.launches
        for i, r in enumerate(rows[:8]):
            check(r["valid?"] is True, f"config1 history {i}: {r}")
        for h, r in zip(hists[8:], rows[8:]):
            valid, st = check_events(ev_mod.history_to_events(h),
                                     return_stats=True)
            check(r["valid?"] == valid
                  and r.get("failed_op_index") == st["failed_op_index"],
                  f"config1 corrupted: {r} vs oracle {valid} {st}")
        check(all(r["method"] == "gpu-wgl-bitset" for r in rows),
              f"config1 methods {[r['method'] for r in rows]}")
        wall = sum(r["wall_s"] for r in rows)
        info.update(
            methods=sorted({r["method"] for r in rows}),
            windows=[r["window"] for r in rows],
            valid=[r["valid?"] for r in rows],
            check_wall_s=[r["wall_s"] for r in rows],
            invoked_ops=1000 * len(hists), wall_s=wall,
            ops_per_s=1000 * len(hists) / wall, **stats,
        )

    with Phase("ladder") as info:
        reset_launch_stats()
        h = sim.gen_cas_counter_history(random.Random(5), n_rounds=40,
                                        n_procs=24)
        hc = sim.corrupt_history(h, random.Random(6), n_values=25)
        t0 = time.perf_counter()
        r = checker.check(None, h)
        rc = checker.check(None, hc)
        wall = time.perf_counter() - t0
        valid, st = check_events(ev_mod.history_to_events(hc),
                                 return_stats=True)
        check(20 <= r["window"] <= 32, f"ladder window {r['window']}")
        check(r["valid?"] is True and r["method"] == "gpu-wgl-kfrontier",
              f"ladder: {r}")
        check(rc["method"] == "gpu-wgl-kfrontier"
              and rc["valid?"] == valid
              and rc.get("failed_op_index") == st["failed_op_index"],
              f"ladder corrupted: {rc} vs oracle {valid} {st}")
        info.update(window=r["window"], method=r["method"],
                    frontier_k=r["frontier_k"],
                    corrupted_failed_op_index=rc["failed_op_index"],
                    op_records=len(h) + len(hc), wall_s=wall,
                    check_wall_s=[r["wall_s"], rc["wall_s"]],
                    **launch_stats_snapshot())

    with Phase("northstar") as info:
        h = sim.gen_register_history(random.Random(9), n_ops=100_000,
                                     n_procs=5, p_crash=0.0002)
        # end to end through the checker, cold
        reset_launch_stats()
        t0 = time.perf_counter()
        r = checker.check(None, h)
        e2e = time.perf_counter() - t0
        check(r["valid?"] is True and r["method"] == "gpu-wgl-bitset",
              f"northstar: {r}")
        e2e_stats = launch_stats_snapshot()
        check(e2e_stats["host_syncs"] == 1, f"northstar syncs {e2e_stats}")
        # the main path ends here: its launch counts are read now, before
        # the timing re-run and the parity launches below
        launches = {"bitset_scan": bs.bitset_scan.launches,
                    "kfrontier_scan": kf.kfrontier_scan.launches}
        a_launches["northstar"] = (launches["bitset_scan"]
                                   - a_launches["config1"])
        # the same check split: host prep (events, steps, plan, pack and
        # upload), then the device scan alone
        t0 = time.perf_counter()
        ev = ev_mod.history_to_events(h)
        steps, segs, _, S = bitset_chain(ev, dev, bs)
        torch.cuda.synchronize()
        prep = time.perf_counter() - t0
        reset_launch_stats()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        r2 = check_events_bucketed(ev, "cas-register")
        e1.record()
        torch.cuda.synchronize()
        dev_wall = time.perf_counter() - t0
        check(r2["valid?"] is True, f"northstar split: {r2}")
        split_stats = launch_stats_snapshot()
        check(split_stats["host_syncs"] == 1, f"northstar {split_stats}")
        info.update(
            invoked_ops=100_000, n_ops=r["n_ops"], window=r["window"],
            segments=[list(s) for s in segs], S=S,
            e2e_wall_s=e2e, e2e_ops_per_s=100_000 / e2e,
            host_prep_s=prep, device_wall_s=dev_wall,
            device_event_s=e0.elapsed_time(e1) / 1e3,
            **e2e_stats,
        )

    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")

    with Phase("northstar_parity") as info:
        # every segment of the north star's chain (W12..W16, S=8, fast
        # tier), on the main path's own inputs, against the plain version
        chain = bitset_chain_parity(ev, dev, bs, exact=False, timed=True)
        info.update(chain)
        parity["bitset_scan"]["max_abs_err"] = max(
            parity["bitset_scan"]["max_abs_err"], chain["max_abs_err"])

    # kernel A's numbers per main-path launch: config1's launches at
    # config1's shape, the north star's one launch per segment
    by_shape = [dict(timing["bitset_scan"], what="config1")]
    by_shape += [dict(r, what=f"northstar segment {k}")
                 for k, r in enumerate(chain["by_shape"])]
    check(a_launches["northstar"] == len(chain["by_shape"]),
          f"north-star launches {a_launches} vs {len(chain['by_shape'])} "
          "segments")
    weights = [a_launches["config1"]] + [1] * len(chain["by_shape"])
    n_a = sum(weights)

    def per_launch(key: str) -> float:
        return sum(w * r[key] for w, r in zip(weights, by_shape)) / n_a

    a_bound = per_launch("bound_ms")
    a_by = "operations" if all(r["bound_by"] == "operations"
                               for r in by_shape) else "bytes"
    compare = None
    if opts.parent:
        with Phase("compare") as info:
            compare = compare_with_parent(os.path.abspath(opts.parent))
            info.update(compare)

    kernels = [
        {
            "name": "bitset_scan", "route": "cuda",
            "source": "jepsen_tpu_torch/csrc/bitset_scan.cu",
            "replaces": "jepsen_tpu/checker/wgl_bitset.py:251",
            "launches": launches["bitset_scan"],
            "max_abs_err": parity["bitset_scan"]["max_abs_err"],
            "ms": per_launch("ms"),
            "plain_ms": per_launch("plain_ms"),
            "bound_ms": a_bound,
            "bound_by": a_by,
            "library_ms": None,
            "shape": (f"mean per launch over the main path's {n_a}: "
                      f"{a_launches['config1']} at config1's shape, one per "
                      f"north-star segment"),
            "by_shape": by_shape,
        },
        {
            "name": "kfrontier_scan", "route": "cuda",
            "source": "jepsen_tpu_torch/csrc/kfrontier_scan.cu",
            "replaces": "jepsen_tpu/checker/wgl_pallas.py:88",
            "launches": launches["kfrontier_scan"],
            "max_abs_err": parity["kfrontier_scan"]["max_abs_err"],
            "ms": timing["kfrontier_scan"]["ms"],
            "plain_ms": timing["kfrontier_scan"]["plain_ms"],
            "bound_ms": timing["kfrontier_scan"]["bound_ms"],
            "bound_by": timing["kfrontier_scan"]["bound_by"],
            "library_ms": None,
            "shape": timing["kfrontier_scan"]["shape"],
            "us_per_step": timing["kfrontier_scan"]["us_per_step"],
        },
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
